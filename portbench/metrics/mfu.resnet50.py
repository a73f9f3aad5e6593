"""mfu.resnet50: images a second a card x 3 x the forward's FLOPs an image
(`configs/resnet50_ref.forward_flops_per_image`) over the bf16 peak."""

from portbench.readers import mfu


def read(run):
    return mfu(run)

"""nccl_share.resnet50: NCCL kernels' device time over the card's busy
time in the traced stretch, rank 0; nothing where no NCCL kernel ran."""

from portbench.readers import device_share


def read(run):
    return device_share(run, "nccl")

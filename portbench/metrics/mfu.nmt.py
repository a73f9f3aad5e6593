"""mfu.nmt: the window's model FLOPs, counted over each pair's real source
and target lengths (`configs/nmt_ref.row_flops`), a second a card over the
f32 peak (TF32 off)."""

from portbench.readers import mfu


def read(run):
    return mfu(run)

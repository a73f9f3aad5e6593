"""idle_share.resnet50: the share of the traced stretch with no kernel or
copy on the card (rank 0's card on several)."""

from portbench.readers import idle_share


def read(run):
    return idle_share(run)

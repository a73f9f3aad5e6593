"""idle_share.nmt: the share of the traced stretch with no kernel or copy
on the card."""

from portbench.readers import idle_share


def read(run):
    return idle_share(run)

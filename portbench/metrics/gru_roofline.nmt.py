"""gru_roofline.nmt: the GRU kernels' share of their roofline in the traced
stretch. The bound is summed over the stretch's batches, two directions
each, of the forward's and the backward's least time at the batch's real
source lengths (`configs/nmt_ref.gru_bound_s`); the measured time is every
`gru_` kernel's (forward walk, backward walk, dW reduction). The same work
is counted whatever kernels do it; nothing where none ran."""


def read(run):
    if run.trace is None or not run.card:
        return None
    h = run.cell.config["hidden_dim"]
    bound = 0.0
    for batch in run.traced_batches:
        lens = batch["source_ids.lengths"]
        b, t = batch["source_ids"].shape
        legs = run.reference.gru_bound_s(lens, t, b, h, run.card)
        bound += 2 * (legs["fwd"] + legs["bwd"])
    measured = run.trace.seconds_where(lambda name: "gru_" in name)
    return 100.0 * bound / measured if measured > 0 else None

"""syncs_per_round: host synchronisations of one round, its scalar
metrics' trip to the host included, as `torch.cuda.set_sync_debug_mode`
reports them."""


def read(rec):
    return rec.get("syncs_per_round")

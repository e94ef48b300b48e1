"""Data-parallel training over a `torch.distributed` process group:
`multihost` starts the group and moves host shards, `mesh` holds the
helpers a data-parallel step needs (world size, this rank's rows,
replicating the train state)."""

"""Distribution layer of the port (``repro/parallel``): logical-axis
sharding rules, the shard-local param and cache trees of tensor-parallel
serving, the collectives the models call, and the sequence-parallel
scan."""

"""Data parallelism over processes (`mesh`) and ZeRO-1 optimizer-state
sharding (`zero`): the port's counterpart of `poet_tpu/parallel/mesh.py`
and `zero.py`. Head-sharded TP and sequence parallelism (`tp.py`) are not
ported (ROADMAP A.6)."""

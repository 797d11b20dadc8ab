"""Multi-process layouts: the counterpart of `poet_tpu/parallel/`. `mesh`:
the process group, the data-only layout and the ('data', 'seq', 'model')
layout over processes; `tp`: head-sharded tensor parallelism and sequence
parallelism over the encoder's tokens; `zero`: ZeRO-1 optimizer-state
sharding over 'data'; `dryrun`: one train step under a layout (JAX's
`__graft_entry__.py:dryrun_multichip`)."""

"""Entity-sharded training over a ``torch.distributed`` mesh (counterpart of
``regcn_tpu/parallel``): ``mesh`` (the ``("data", "graph")`` mesh),
``collectives`` (the autograd collectives), ``halo`` (edge partitions and
the two cross-shard aggregations) and ``sharding`` (the split of the train
state into each rank's rows, and the sharded steps). Nothing is imported
here, so the model modules can import ``collectives`` and ``halo`` without
``sharding``, which imports the models."""

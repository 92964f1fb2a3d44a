"""Multi-GPU training and evaluation on ``torch.distributed``.

Counterpart of ``rnn_speech_tpu/parallel``.  The JAX package runs one
process a host driving a ``Mesh`` of its devices through ``shard_map``;
the port runs one process a GPU (a rank), started by
``torch.distributed.run`` or by hand with ``RST_MULTIHOST``, and its mesh
is a grid of ranks: ``launch`` starts the process group, ``mesh`` lays the
ranks out as ("data", "model"), ``sharding`` builds the sharded train and
eval steps, ``lockstep`` agrees the number of dispatches of an evaluation
pass, and ``dryrun`` runs both layouts on the CPU.
"""

"""File formats the port reads and writes without third-party packages:
Parquet feature shards (:mod:`~tmlibrary_tpu_torch.io.parquet`) and the
raw snappy codec their pages use (:mod:`~tmlibrary_tpu_torch.io.snappy`)."""

"""File formats the port reads and writes without third-party packages:
Parquet feature shards and static mapobject shards
(:mod:`~tmlibrary_tpu_torch.io.parquet`), the raw snappy codec their
pages use (:mod:`~tmlibrary_tpu_torch.io.snappy`) and PNG tiles and
planes (:mod:`~tmlibrary_tpu_torch.io.png`)."""

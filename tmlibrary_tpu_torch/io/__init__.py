"""File formats the port reads and writes without third-party packages:
Parquet feature shards and static mapobject shards
(:mod:`~tmlibrary_tpu_torch.io.parquet`), the raw snappy codec their
pages use (:mod:`~tmlibrary_tpu_torch.io.snappy`), PNG tiles and
planes (:mod:`~tmlibrary_tpu_torch.io.png`) and the HDF5 that h5py
reads and writes (:mod:`~tmlibrary_tpu_torch.io.hdf5`, with the
version-2 structures in :mod:`~tmlibrary_tpu_torch.io.hdf5_v2`)."""

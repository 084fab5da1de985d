"""Experiment data model and on-disk store of the port.

Counterpart: ``tmlibrary_tpu/models/``: the manifest
(:mod:`~tmlibrary_tpu_torch.models.experiment`), the store
(:mod:`~tmlibrary_tpu_torch.models.store`), the illumination statistics
container (:mod:`~tmlibrary_tpu_torch.models.image`), the mapobject
type registry and static outlines
(:mod:`~tmlibrary_tpu_torch.models.mapobject`), the metadata records
(:mod:`~tmlibrary_tpu_torch.models.metadata`) and the users and
experiment shares (:mod:`~tmlibrary_tpu_torch.models.user`).
"""

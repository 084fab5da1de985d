"""Experiment data model and on-disk store of the port.

Counterpart: ``tmlibrary_tpu/models/``: the manifest
(:mod:`~tmlibrary_tpu_torch.models.experiment`), the store
(:mod:`~tmlibrary_tpu_torch.models.store`), the illumination statistics
container (:mod:`~tmlibrary_tpu_torch.models.image`) and the mapobject
type registry (:mod:`~tmlibrary_tpu_torch.models.mapobject`).
"""

"""Deep-learning segmentation: the flow-field U-Net, its decoder and its
checkpoints.

Counterpart: ``tmlibrary_tpu/nn``.  :mod:`.unet` runs the reference's
net in PyTorch from the same ``.npz`` parameters, :mod:`.decode` turns
its head into labels with integer work around the labeling kernel, and
:mod:`.weights` resolves weight specs to parameters and content
digests.  The jterator modules ``segment_dl_primary`` and
``segment_dl_secondary`` use them.
"""

from tmlibrary_tpu_torch.nn.decode import (  # noqa: F401
    decode_flows,
    decode_secondary,
    follow_flows,
)
from tmlibrary_tpu_torch.nn.unet import (  # noqa: F401
    OUT_CHANNELS,
    UNet,
    UNetConfig,
    infer_config,
    init_unet_params,
    normalize_image,
    params_from_numpy,
    unet_flops,
    unet_for,
    unet_io_bytes,
)
from tmlibrary_tpu_torch.nn.weights import (  # noqa: F401
    list_weights,
    load_weights,
    params_digest,
    resolve_weights,
    save_weights,
    weights_digest,
    weights_dir,
)

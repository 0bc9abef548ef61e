"""Hub entry points of the port: the names the repository's `hubconf.py`
exports for the JAX package (`beat_this` is `load_model`, then the model
class and the inference tower), importable as

    from beat_this_tpu_torch.hub import beat_this, File2Beats

`load_model(checkpoint_path, device)` takes a local checkpoint file, a URL
or a released shortname (fetched once into $BEAT_THIS_CACHE).
"""

dependencies = ["torch", "numpy"]

from beat_this_tpu_torch.inference import (  # noqa: F401, E402
    Audio2Beats,
    Audio2Frames,
    File2Beats,
    File2File,
    Spect2Frames,
    load_model as beat_this,
)
from beat_this_tpu_torch.model.beat_this import BeatThis  # noqa: F401, E402

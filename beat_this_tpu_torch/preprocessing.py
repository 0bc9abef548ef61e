"""Module path of the reference's `beat_this.preprocessing`
(beat_this/preprocessing.py), as beat_this_tpu/preprocessing.py has it:
`load_audio`, `LogMelConfig` and `LogMelSpect` from the port's own
modules."""

from beat_this_tpu_torch.io.audio import load_audio  # noqa: F401
from beat_this_tpu_torch.ops.mel import LogMelConfig, LogMelSpect  # noqa: F401

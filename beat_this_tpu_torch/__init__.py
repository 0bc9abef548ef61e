"""beat_this_tpu_torch — the Beat This! beat and downbeat tracker on PyTorch,
with hand-written CUDA kernels for NVIDIA Hopper (sm_90a).

A port of the JAX/TPU package `beat_this_tpu`, which stays the reference it
is tested against. Public API as the reference (beat_this/inference.py):
    Spect2Frames, Audio2Frames, Audio2Beats, File2Beats, File2File, load_model
"""

__version__ = "0.1.0"

_INFERENCE_EXPORTS = (
    "Spect2Frames",
    "Audio2Frames",
    "Audio2Beats",
    "File2Beats",
    "File2File",
    "load_model",
)


def __getattr__(name):  # lazy re-export to keep `import beat_this_tpu_torch` light
    if name in _INFERENCE_EXPORTS:
        import beat_this_tpu_torch.inference as _inf

        return getattr(_inf, name)
    raise AttributeError(name)

"""High-quality polyphase audio resampling (soxr-equivalent role).

The reference delegates resampling to the `soxr` C library
(reference: beat_this/inference.py:275, launch_scripts/preprocess_audio.py:26).
Here it is a first-class component: a Kaiser-windowed-sinc polyphase
resampler with a native C++ kernel (native/resample.cpp, loaded via ctypes)
and a vectorized numpy fallback with identical output. Filter design targets
>120 dB stopband (beta=14.77, 64 zero crossings), comfortably beyond audible
parity for the 50 fps mel frontend.

The hot inference path never needs this on device (preprocessed datasets are
already at 22050 Hz); it runs host-side on file input, so the implementation
optimizes for exactness + multicore C++ throughput rather than XLA fusion.

The port's copy of beat_this_tpu/ops/resample.py, kept so that the port imports nothing of
the JAX package; the tests hold the two to identical results.
"""

from __future__ import annotations

import ctypes
import functools
import math
from pathlib import Path

import numpy as np

_KAISER_BETA = 14.769656459379492  # ~140 dB sidelobe attenuation
_ZEROS = 64  # sinc zero crossings on each side
_ROLLOFF = 0.9475937167399596


@functools.lru_cache(maxsize=32)
def _design_filter(L: int, M: int) -> np.ndarray:
    """Prototype lowpass for L/M resampling, length odd, gain L at passband.

    Cutoff at min(1/L, 1/M) * rolloff (normalized to the upsampled rate L*sr).
    """
    cutoff = _ROLLOFF * min(1.0 / L, 1.0 / M)
    half = int(math.ceil(_ZEROS / cutoff))
    n = np.arange(-half, half + 1, dtype=np.float64)
    taps = cutoff * np.sinc(cutoff * n)
    taps *= np.kaiser(2 * half + 1, _KAISER_BETA)
    return (taps * L).astype(np.float64)


_native_lib = None


def _load_native():
    global _native_lib
    if _native_lib is not None:
        return _native_lib
    so = Path(__file__).resolve().parent.parent.parent / "native" / "libbtnative.so"
    if so.exists():
        lib = ctypes.CDLL(str(so))
        lib.bt_resample_poly.restype = ctypes.c_longlong
        lib.bt_resample_poly.argtypes = [
            ctypes.POINTER(ctypes.c_double), ctypes.c_longlong,  # x, n_in
            ctypes.POINTER(ctypes.c_double), ctypes.c_longlong,  # h, n_taps
            ctypes.c_longlong, ctypes.c_longlong,  # L, M
            ctypes.POINTER(ctypes.c_double), ctypes.c_longlong,  # y, n_out
        ]
        _native_lib = lib
    else:
        _native_lib = False
    return _native_lib


def _resample_poly_numpy(x: np.ndarray, h: np.ndarray, L: int, M: int) -> np.ndarray:
    """upfirdn(h, x, L, M) centered: y[n] = sum_k h[n*M - k*L + off] x[k]."""
    n_in = len(x)
    n_out = int(math.ceil(n_in * L / M))
    half = (len(h) - 1) // 2
    y = np.zeros(n_out, dtype=np.float64)
    # polyphase: output n takes input phase p = (n*M + half) % L
    # and input anchor k0 = (n*M + half) // L
    # y[n] = sum_j h[p + j*L] * x[k0 - j]
    for p in range(L):
        # taps of this phase
        hp = h[p::L][::-1]  # reversed for correlation below
        t = len(hp)
        # outputs using this phase: n*M + half ≡ p (mod L)
        # solve n*M ≡ p - half (mod L)
        g = math.gcd(M, L)
        rhs = (p - half) % L
        if rhs % g != 0:
            continue
        Mg, Lg, rg = M // g, L // g, rhs // g
        n0 = (rg * pow(Mg, -1, Lg)) % Lg if Lg > 1 else 0
        ns = np.arange(n0, n_out, Lg)
        if len(ns) == 0:
            continue
        k0 = (ns * M + half) // L  # anchor input index
        # window x[k0 - t + 1 : k0 + 1] dot hp
        xp = np.pad(x.astype(np.float64), (t - 1, t))
        idx = k0[:, None] + np.arange(t)[None, :]  # into padded (offset t-1)
        windows = xp[idx]
        y[ns] = windows @ hp
    return y


def resample(x: np.ndarray, in_rate: int, out_rate: int) -> np.ndarray:
    """Resample a mono float waveform from `in_rate` to `out_rate` Hz.

    API mirrors `soxr.resample(x, in_rate, out_rate)` for 1-D input. Output
    length is ceil(n * out_rate / in_rate), matching soxr.
    """
    if in_rate == out_rate:
        return np.asarray(x)
    g = math.gcd(int(in_rate), int(out_rate))
    L = int(out_rate) // g
    M = int(in_rate) // g
    h = _design_filter(L, M)
    x64 = np.ascontiguousarray(x, dtype=np.float64)
    lib = _load_native()
    n_out = int(math.ceil(len(x64) * L / M))
    if lib:
        y = np.empty(n_out, dtype=np.float64)
        lib.bt_resample_poly(
            x64.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
            len(x64),
            h.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
            len(h),
            L,
            M,
            y.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
            n_out,
        )
    else:
        y = _resample_poly_numpy(x64, h, L, M)
    return y.astype(np.asarray(x).dtype if np.asarray(x).dtype.kind == "f" else np.float64)

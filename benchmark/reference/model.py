"""The Beat This! model (beat_this/model/beat_tracker.py, roformer.py) as
plain PyTorch functions over a state dict under the reference checkpoint's
parameter names, in float32 with TF32 off.

Frontend: batch norm over the mel bins, a (4, 3) stem convolution (stride 4
over frequency) with batch norm and GELU, then three blocks, each a
partial transformer (a roformer block along frequency, then one along time)
and a (2, 3) convolution (stride 2 over frequency) with batch norm and GELU;
the (channel, frequency) features are projected to the transformer width.
Then `n_layers` roformer blocks along time, an RMS norm and the sum head
(beat logit = beat + downbeat output).

A roformer block is x + gated rotary attention (pre RMS norm, interleaved-
pair RoPE with theta 10000, sigmoid gates per head from the normed rows),
then x + feed-forward (pre RMS norm, exact GELU, 4x width).

`valid_lengths` are not needed: a piece shorter than a window runs at its
own length. Training uses batch statistics and dropout at the program's
stated sites, drawn again from its seeds (`philox`).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
import torch.utils.checkpoint

from . import philox
from .quant import Quant

HEAD_DIM = 32
BN_EPS = 1e-5


def param_shapes(cfg: dict) -> dict[str, tuple]:
    """Every parameter and statistic of the model, by checkpoint name."""
    d, mult, stem, mels = cfg["transformer_dim"], cfg["ff_mult"], cfg["stem_dim"], cfg["spect_dim"]
    shapes: dict[str, tuple] = {}

    def bn(name, c):
        for k in ("weight", "bias", "running_mean", "running_var"):
            shapes[f"{name}.{k}"] = (c,)

    def attn(name, c):
        heads = c // cfg["head_dim"]
        shapes[f"{name}.norm.gamma"] = (c,)
        shapes[f"{name}.to_qkv.weight"] = (3 * heads * cfg["head_dim"], c)
        shapes[f"{name}.to_gates.weight"] = (heads, c)
        shapes[f"{name}.to_gates.bias"] = (heads,)
        shapes[f"{name}.to_out.0.weight"] = (c, heads * cfg["head_dim"])

    def ff(name, c, m):
        shapes[f"{name}.net.0.gamma"] = (c,)
        shapes[f"{name}.net.1.weight"] = (m * c, c)
        shapes[f"{name}.net.1.bias"] = (m * c,)
        shapes[f"{name}.net.4.weight"] = (c, m * c)
        shapes[f"{name}.net.4.bias"] = (c,)

    bn("frontend.stem.bn1d", mels)
    shapes["frontend.stem.conv2d.weight"] = (stem, 1, 4, 3)
    bn("frontend.stem.bn2d", stem)
    for i in range(3):
        c = stem * 2**i
        p = f"frontend.blocks.{i}"
        if cfg["partial_transformers"]:
            attn(f"{p}.partial.attnF", c)
            ff(f"{p}.partial.ffF", c, 4)
            attn(f"{p}.partial.attnT", c)
            ff(f"{p}.partial.ffT", c, 4)
        shapes[f"{p}.conv2d.weight"] = (2 * c, c, 2, 3)
        bn(f"{p}.norm", 2 * c)
    shapes["frontend.linear.weight"] = (d, stem * 8 * (mels // 32))
    shapes["frontend.linear.bias"] = (d,)
    for i in range(cfg["n_layers"]):
        attn(f"transformer_blocks.layers.{i}.0", d)
        ff(f"transformer_blocks.layers.{i}.1", d, mult)
    shapes["transformer_blocks.norm.gamma"] = (d,)
    shapes["task_heads.beat_downbeat_lin.weight"] = (2, d)
    shapes["task_heads.beat_downbeat_lin.bias"] = (2,)
    return shapes


def rope(n: int, device) -> tuple[torch.Tensor, torch.Tensor]:
    inv = 1.0 / (10000.0 ** (torch.arange(0, HEAD_DIM, 2, dtype=torch.float64) / HEAD_DIM))
    ang = torch.outer(torch.arange(n, dtype=torch.float64), inv)
    return ang.cos().float().to(device), ang.sin().float().to(device)


def apply_rope(x, cos, sin):
    even, odd = x[..., 0::2], x[..., 1::2]
    return torch.stack([even * cos - odd * sin, odd * cos + even * sin], -1).reshape(x.shape)


def rms(x, gamma):
    return x / x.norm(dim=-1, keepdim=True).clamp_min(1e-12) * x.shape[-1] ** 0.5 * gamma


class Reference:
    """The model over state dict `p` (float32 tensors on one device).

    `quant` rounds the operands of every product (the control). `seeds`,
    in training, is the program's stream of per-call dropout seeds
    (`seed_stream`)."""

    def __init__(self, cfg: dict, p: dict, quant: Optional[Quant] = None):
        self.cfg, self.p, self.q = cfg, p, quant or Quant()

    def lin(self, x, w, b=None):
        y = F.linear(self.q(x), self.q(self.p[w]))
        return y if b is None else y + self.p[b]

    def bn(self, name, x, train):
        if train:
            axes = tuple(range(x.ndim - 1))
            mean = x.mean(axes)
            var = x.square().mean(axes) - mean.square()
        else:
            mean, var = self.p[f"{name}.running_mean"], self.p[f"{name}.running_var"]
        scale = self.p[f"{name}.weight"] * torch.rsqrt(var + BN_EPS)
        return x * scale + (self.p[f"{name}.bias"] - mean * scale)

    def conv(self, w, x, stride_freq):
        """(b, t, f, c) -> (b, t, f / stride, out): kernel (freq, time) with
        time padded by 1 on both sides."""
        y = F.conv2d(self.q(x.permute(0, 3, 1, 2)), self.q(self.p[w].permute(0, 1, 3, 2)),
                     stride=(1, stride_freq), padding=(1, 0))
        return y.permute(0, 2, 3, 1)

    def attention(self, name, x, drop):
        """The attention branch on (items, n, c). `drop`: None, or (rate,
        seed, salt, prob_item0, out_row0) of the call's dropout."""
        items, n, c = x.shape
        heads = c // HEAD_DIM
        g = rms(x, self.p[f"{name}.norm.gamma"])
        qkv = self.lin(g, f"{name}.to_qkv.weight")
        qkv = qkv.reshape(items, n, 3, heads, HEAD_DIM).permute(2, 0, 3, 1, 4)
        cos, sin = rope(n, x.device)
        q, k, v = apply_rope(qkv[0], cos, sin), apply_rope(qkv[1], cos, sin), qkv[2]
        p = torch.softmax(self.q(q) @ self.q(k).transpose(-1, -2) * HEAD_DIM**-0.5, -1)
        if drop is not None:
            rate, seed, salt, _, _ = drop
            keep = philox.keep_mask(seed, salt, philox.SITE_ATTN_PROBS, items, heads, n, n, rate,
                                    x.device)
            p = p * keep * philox.keep_scale(rate)
        o = self.q(p) @ self.q(v)
        gates = torch.sigmoid(self.lin(g, f"{name}.to_gates.weight", f"{name}.to_gates.bias"))
        o = (o * gates.transpose(1, 2)[..., None]).transpose(1, 2).reshape(items, n, c)
        out = self.lin(o, f"{name}.to_out.0.weight")
        if drop is not None:
            rate, seed, salt, _, row0 = drop
            out = out * philox.rows_keep(seed, salt, philox.SITE_ATTN_OUT, out.shape, rate,
                                         x.device, row0)
        return out

    def feed_forward(self, name, x, drop):
        """x + the feed-forward branch; `drop` as `attention`."""
        g = rms(x, self.p[f"{name}.net.0.gamma"])
        h = F.gelu(self.lin(g, f"{name}.net.1.weight", f"{name}.net.1.bias"))
        if drop is not None:
            rate, seed, salt, _, row0 = drop
            h = h * philox.rows_keep(seed, salt, philox.SITE_FF_HIDDEN, h.shape, rate, x.device,
                                     row0)
        y = self.lin(h, f"{name}.net.4.weight", f"{name}.net.4.bias")
        if drop is not None:
            y = y * philox.rows_keep(seed, salt, philox.SITE_FF_OUT, y.shape, rate, x.device,
                                     row0)
        return x + y

    def roformer(self, attn, ff, x, train, rate, seeds, fused_freq):
        """One roformer block on (items, n, c). In training the program
        draws one seed for a frequency block (all four sites under
        SALT_FREQ) and one each for a time block's attention and
        feed-forward."""
        if not train or rate == 0.0:
            return self.feed_forward(ff, x + self.attention(attn, x, None), None)
        if fused_freq:
            s = next(seeds)
            da = df = (rate, s, philox.SALT_FREQ, 0, 0)
        else:
            da = (rate, next(seeds), philox.SALT_ATTN, 0, 0)
            df = (rate, next(seeds), philox.SALT_FF, 0, 0)

        def branch(x):
            return x + self.attention(attn, x, da)

        x = torch.utils.checkpoint.checkpoint(branch, x, use_reentrant=False)
        return torch.utils.checkpoint.checkpoint(self.feed_forward, ff, x, df,
                                                 use_reentrant=False)

    def features(self, x, train=False, seeds=None):
        cfg = self.cfg
        b, t, _ = x.shape
        rate_f = cfg["dropout_frontend"] if train else 0.0
        rate_t = cfg["dropout_transformer"] if train else 0.0
        h = self.bn("frontend.stem.bn1d", x, train)[..., None]
        h = F.gelu(self.bn("frontend.stem.bn2d",
                           self.conv("frontend.stem.conv2d.weight", h, 4), train))
        for i in range(3):
            pre = f"frontend.blocks.{i}"
            c, f = h.shape[-1], h.shape[2]
            if cfg["partial_transformers"]:
                hf = self.roformer(f"{pre}.partial.attnF", f"{pre}.partial.ffF",
                                   h.reshape(b * t, f, c), train, rate_f, seeds, True)
                ht = hf.reshape(b, t, f, c).transpose(1, 2).reshape(b * f, t, c)
                ht = self.roformer(f"{pre}.partial.attnT", f"{pre}.partial.ffT", ht, train,
                                   rate_f, seeds, False)
                h = ht.reshape(b, f, t, c).transpose(1, 2)
            h = F.gelu(self.bn(f"{pre}.norm", self.conv(f"{pre}.conv2d.weight", h, 2), train))
        h = self.lin(h.transpose(2, 3).reshape(b, t, -1), "frontend.linear.weight",
                     "frontend.linear.bias")
        for i in range(cfg["n_layers"]):
            pre = f"transformer_blocks.layers.{i}"
            h = self.roformer(f"{pre}.0", f"{pre}.1", h, train, rate_t, seeds, False)
        return rms(h, self.p["transformer_blocks.norm.gamma"])

    def forward(self, x, train=False, seeds=None):
        """(b, t, mels) log-mel -> (beat, downbeat) logits, (b, t) each."""
        y = self.lin(self.features(x, train, seeds), "task_heads.beat_downbeat_lin.weight",
                     "task_heads.beat_downbeat_lin.bias")
        down = y[..., 1]
        beat = y[..., 0] + down if self.cfg["sum_head"] else y[..., 0]
        return beat, down


def seed_stream(seed: int):
    """The program's per-call dropout seeds of one training forward: int32
    draws from a CPU torch.Generator seeded with the microbatch's seed."""
    gen = torch.Generator().manual_seed(int(seed))
    while True:
        yield int(torch.randint(0, 2**31 - 1, (1,), generator=gen))

"""Port of repro/models/mamba2.py: Mamba2 / SSD (state-space duality)
blocks. [arXiv:2405.21060]

The chunked SSD algorithm: within a chunk the recurrence is evaluated as
masked (attention-like) matrix products; across chunks a sequential state
recurrence carries ``[B, H, P, N]`` states. Decode keeps an O(1) recurrent
state and a depthwise-conv tail.

Shapes: x ``[B, S, H, P]`` (P = head channels), dt ``[B, S, H]``, A ``[H]``,
B/C ``[B, S, G, N]`` (G groups broadcast over H heads), state
``[B, H, P, N]``. All decay math in float32; the data path, the scan carry
and ``init_state`` stay in the compute dtype (in bf16 the SSM state is
bf16), as in the JAX package.

The JAX package's SSD is ``jnp`` code, not a Pallas kernel, so this port is
plain PyTorch, op for op: ``segsum`` keeps the masked-broadcast ``cumsum``
(not the shortcut ``a_cum[i] - a_cum[j]``, which rounds differently), and
the ``lax.scan`` over chunks is a loop that carries the state in the same
order. The functions take the JAX package's parameter layout as mappings
(``p["in_proj"]`` ...); ``MambaBlock`` owns the parameters and hands them
out (``params(dtype)``).
"""
from __future__ import annotations

from typing import Dict, Mapping, Optional, Tuple

import torch
from torch.nn import functional as F

from ..configs.base import ModelConfig
from . import layers as L

Tensors = Mapping[str, torch.Tensor]

# leaves the JAX block functions use as fp32 masters (never cast)
_FP32_LEAVES = ("A_log", "dt_bias", "norm")

# the profiler range around each ``ssd_chunked`` call of a block: a trace
# reads the SSD's device time from it (its forward and remat's recomputes,
# and the backward of the operators run inside it)
SSD_SPAN = "mamba2.ssd_chunked"


# ---------------------------------------------------------------------------
# Parameters
# ---------------------------------------------------------------------------


class MambaBlock(L.ParamGroup):
    """One mamba2 block's parameters (``init_mamba_block``): the pre-norm
    ``ln`` and, flat beside it, ``in_proj [D, 2 d_in + 2 G N + H]``,
    ``conv_w [W, Ch]``, ``conv_b [Ch]``, ``A_log``, ``dt_bias``, ``D``
    ``[H]``, ``norm [d_in]`` and ``out_proj [d_in, D]``."""

    def __init__(self, cfg: ModelConfig, device):
        d, d_in = cfg.d_model, cfg.d_inner
        g, n, h = cfg.ssm_groups, cfg.ssm_state, cfg.ssm_heads
        conv_ch = d_in + 2 * g * n
        super().__init__({
            "in_proj": (d, 2 * d_in + 2 * g * n + h),  # z, x, B, C, dt
            "conv_w": (cfg.ssm_conv, conv_ch), "conv_b": (conv_ch,),
            "A_log": (h,), "dt_bias": (h,), "D": (h,), "norm": (d_in,),
            "out_proj": (d_in, d)}, device)
        self.ln = L.Norm(cfg, device)
        with torch.no_grad():
            # A in [-16, -1]; softplus(-2) ~ 0.12
            self.A_log.copy_(torch.log(torch.linspace(
                1.0, 16.0, h, dtype=torch.float32, device=device)))
            self.dt_bias.fill_(-2.0)
            self.D.fill_(1.0)
            self.norm.fill_(1.0)

    def init_(self, cfg: ModelConfig, gen: torch.Generator) -> None:
        dev = self.in_proj.device
        with torch.no_grad():
            self.in_proj.copy_(L._normal(self.in_proj.shape,
                                         cfg.d_model ** -0.5, gen, dev))
            self.conv_w.copy_(L._normal(self.conv_w.shape, 0.1, gen, dev))
            self.out_proj.copy_(L._normal(self.out_proj.shape,
                                          cfg.d_inner ** -0.5, gen, dev))
        self._cast.clear()

    def params(self, dtype=torch.float32) -> Dict[str, object]:
        """The mapping the block functions take: the weights the JAX package
        casts at each use in ``dtype`` (cast once and kept), ``A_log``,
        ``dt_bias`` and ``norm`` as fp32 masters, and ``ln``."""
        cast, master = self.tensors(dtype), self.tensors()
        p: Dict[str, object] = {k: master[k] if k in _FP32_LEAVES else v
                                for k, v in cast.items()}
        p["ln"] = self.ln.tensors()
        return p


def _split_proj(cfg: ModelConfig, zxbcdt: torch.Tensor):
    d_in, g, n, h = cfg.d_inner, cfg.ssm_groups, cfg.ssm_state, cfg.ssm_heads
    return torch.split(zxbcdt, [d_in, d_in, g * n, g * n, h], dim=-1)


def _expand_groups(v: torch.Tensor, n_heads: int) -> torch.Tensor:
    """[..., G, N] -> [..., H, N] broadcast of B/C groups over heads."""
    g = v.shape[-2]
    if g == n_heads:
        return v
    return v.repeat_interleave(n_heads // g, dim=-2)


# ---------------------------------------------------------------------------
# Chunked SSD core
# ---------------------------------------------------------------------------


def segsum(a: torch.Tensor) -> torch.Tensor:
    """Cumulative segment sums: out[..., i, j] = sum_{k=j+1..i} a[..., k]
    for i >= j, else -inf. a: [..., Q] -> [..., Q, Q]."""
    q = a.shape[-1]
    x = a[..., :, None].expand(a.shape + (q,))  # [..., d(src k), e]
    ones = torch.ones((q, q), dtype=torch.bool, device=a.device)
    x = torch.where(torch.tril(ones, diagonal=-1), x, 0.0)
    out = torch.cumsum(x, dim=-2)
    return torch.where(torch.tril(ones), out, -torch.inf)


def _pad_seq(t: torch.Tensor, pad: int) -> torch.Tensor:
    """Zero rows appended on axis 1."""
    return torch.cat([t, t.new_zeros((t.shape[0], pad) + t.shape[2:])], 1)


def ssd_chunked(
    x: torch.Tensor,
    dt: torch.Tensor,
    A: torch.Tensor,
    B: torch.Tensor,
    C: torch.Tensor,
    chunk: int,
    init_state: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """SSD over a full sequence. Returns (y [B,S,H,P], final_state
    [B,H,P,N]). x [B,S,H,P]; dt [B,S,H] (already softplus'd); A [H]
    (negative); B/C [B,S,G,N]."""
    b, s, h, p = x.shape
    orig_s = s
    if s % chunk:
        # zero-pad to a chunk multiple: dt == 0 makes padded steps identity
        # transitions (decay exp(0) = 1, contribution 0), so the final state
        # is exact; padded outputs are sliced off below
        pad = chunk - s % chunk
        x, dt, B, C = (_pad_seq(t, pad) for t in (x, dt, B, C))
        s = x.shape[1]
    nc, q = s // chunk, chunk
    n = B.shape[-1]

    Bh = _expand_groups(B, h)  # [B,S,H,N]
    Ch = _expand_groups(C, h)

    # chunked views
    xc = x.reshape(b, nc, q, h, p)
    dtc = dt.reshape(b, nc, q, h).float()
    Bc = Bh.reshape(b, nc, q, h, n)
    Cc = Ch.reshape(b, nc, q, h, n)

    a = dtc * A  # [b,nc,q,h] (negative decays)
    a_hq = a.movedim(-1, -2)  # [b,nc,h,q]
    a_cum = torch.cumsum(a_hq, dim=-1)  # [b,nc,h,q]

    # the data path in the compute dtype (decay math stays fp32)
    xdt = xc * dtc[..., None].to(xc.dtype)  # x * dt

    # 1) intra-chunk (diagonal blocks): masked attention-like products
    Lmat = torch.exp(segsum(a_hq))  # [b,nc,h,q,q]
    scores = torch.einsum("bclhn,bcshn->bchls", Cc, Bc)  # [b,nc,h,q,q]
    y_diag = torch.einsum("bchls,bcshp->bclhp",
                          scores * Lmat.to(scores.dtype), xdt)

    # 2) chunk states: decayed sum of inputs within each chunk
    decay_states = torch.exp(a_cum[..., -1:] - a_cum)  # [b,nc,h,q]
    states = torch.einsum(
        "bcshn,bcshp->bchpn",
        Bc * decay_states.to(x.dtype).movedim(-1, -2)[..., None], xdt)

    # 3) inter-chunk recurrence (sequential over chunks, as lax.scan)
    chunk_decay = torch.exp(a_cum[..., -1])  # [b,nc,h]
    prev = (init_state if init_state is not None
            else torch.zeros((b, h, p, n), dtype=x.dtype, device=x.device))
    entered = []
    for c in range(nc):
        entered.append(prev)  # the state entering chunk c
        st = states[:, c]
        prev = st + chunk_decay[:, c][..., None, None].to(st.dtype) * prev
    final_state = prev
    prev_states = torch.stack(entered, dim=1)  # [b,nc,h,p,n]

    # 4) inter-chunk contribution to outputs
    state_decay_out = torch.exp(a_cum)  # [b,nc,h,q]
    y_off = torch.einsum("bclhn,bchpn->bclhp", Cc, prev_states) \
        * state_decay_out.to(x.dtype).movedim(-1, -2)[..., None]

    y = (y_diag + y_off).reshape(b, s, h, p)
    return y[:, :orig_s], final_state


def ssd_decode_step(
    x_t: torch.Tensor,
    dt_t: torch.Tensor,
    A: torch.Tensor,
    B_t: torch.Tensor,
    C_t: torch.Tensor,
    state: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One recurrent step. x_t [B,H,P]; dt_t [B,H]; B_t/C_t [B,G,N];
    state [B,H,P,N] -> (y [B,H,P], new_state)."""
    h = x_t.shape[1]
    Bh = _expand_groups(B_t, h)  # [B,H,N]
    Ch = _expand_groups(C_t, h)
    dA = torch.exp(dt_t.float() * A).to(state.dtype)  # [B,H]
    xdt = x_t * dt_t[..., None].to(x_t.dtype)
    new_state = state * dA[..., None, None] + torch.einsum(
        "bhp,bhn->bhpn", xdt, Bh)
    y = torch.einsum("bhpn,bhn->bhp", new_state, Ch)
    return y, new_state


# ---------------------------------------------------------------------------
# Conv + full block
# ---------------------------------------------------------------------------


def causal_conv(
    xbc: torch.Tensor, w: torch.Tensor, bias: torch.Tensor,
    left_context: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Depthwise causal conv1d. xbc [B, S, Ch]; w [W, Ch].

    ``left_context`` [B, W-1, Ch]: the previous chunk's tail (chunked
    prefill); zeros when starting from scratch."""
    width, s = w.shape[0], xbc.shape[1]
    if left_context is None:
        pad = torch.cat([xbc.new_zeros((xbc.shape[0], width - 1,
                                        xbc.shape[2])), xbc], dim=1)
    else:
        pad = torch.cat([left_context.to(xbc.dtype), xbc], dim=1)
    out = torch.zeros_like(xbc)
    for i in range(width):  # width is tiny (4): unrolled taps
        out = out + pad[:, i:i + s] * w[i].to(xbc.dtype)
    return F.silu(out + bias.to(xbc.dtype))


def conv_decode_step(
    tail: torch.Tensor, xbc_t: torch.Tensor, w: torch.Tensor,
    bias: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """tail [B, W-1, Ch] (previous inputs), xbc_t [B, Ch] -> (out [B, Ch],
    new tail)."""
    window = torch.cat([tail, xbc_t[:, None]], dim=1)  # [B, W, Ch]
    out = torch.einsum("bwc,wc->bc", window, w.to(xbc_t.dtype))
    out = F.silu(out + bias.to(xbc_t.dtype))
    return out, window[:, 1:]


def gated_rmsnorm(y: torch.Tensor, z: torch.Tensor, scale: torch.Tensor,
                  eps: float) -> torch.Tensor:
    """Mamba2 output norm: RMSNorm(y * silu(z)) * scale."""
    g = (y * F.silu(z)).float()
    var = g.square().mean(dim=-1, keepdim=True)
    return (g * torch.rsqrt(var + eps) * scale).to(y.dtype)


def _mix(cfg: ModelConfig, p: Tensors, u: torch.Tensor):
    """The block's input half: pre-norm, ``in_proj`` and the split
    (z, xBC before the conv, dt)."""
    x = L.apply_norm(cfg, p["ln"], u)
    zxbcdt = torch.einsum("...d,dk->...k", x, p["in_proj"].to(u.dtype))
    z, xs, bb, cc, dt = _split_proj(cfg, zxbcdt)
    return z, torch.cat([xs, bb, cc], dim=-1), dt


def _ssd_out(cfg: ModelConfig, p: Tensors, u: torch.Tensor, z, xbc, dt,
             init_state):
    """The block's output half over a sequence: SSD, the D skip, the gated
    norm, ``out_proj`` and the residual. Returns (out, final state)."""
    dtype = u.dtype
    h, pd, g, n = cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_groups, cfg.ssm_state
    xs, bb, cc = torch.split(xbc, [cfg.d_inner, g * n, g * n], dim=-1)
    b, s, _ = u.shape
    dt = F.softplus(dt.float() + p["dt_bias"])
    A = -torch.exp(p["A_log"])
    xs = xs.reshape(b, s, h, pd)
    with torch.profiler.record_function(SSD_SPAN):
        y, final_state = ssd_chunked(xs, dt, A, bb.reshape(b, s, g, n),
                                     cc.reshape(b, s, g, n), cfg.ssm_chunk,
                                     init_state)
    y = y + p["D"].to(dtype)[None, None, :, None] * xs
    y = gated_rmsnorm(y.reshape(b, s, cfg.d_inner), z, p["norm"],
                      cfg.norm_eps)
    out = torch.einsum("bsk,kd->bsd", y, p["out_proj"].to(dtype))
    return u + out, final_state


def mamba_block(
    cfg: ModelConfig, p: Tensors, u: torch.Tensor, init_state=None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Full-sequence mamba2 block. u [B, S, D] -> (out [B,S,D], final ssm
    state [B,H,P,N], conv tail [B,W-1,Ch])."""
    z, xbc, dt = _mix(cfg, p, u)
    conv_tail = xbc[:, -(cfg.ssm_conv - 1):]  # pre-conv inputs feed decode
    xbc = causal_conv(xbc, p["conv_w"], p["conv_b"])
    out, final_state = _ssd_out(cfg, p, u, z, xbc, dt, init_state)
    return out, final_state, conv_tail


def mamba_block_chunk(
    cfg: ModelConfig,
    p: Tensors,
    u: torch.Tensor,           # [B, C, D] one chunk
    ssm_state: torch.Tensor,   # [B, H, P, N] state entering the chunk
    conv_tail: torch.Tensor,   # [B, W-1, Ch] previous chunk's pre-conv tail
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Chunked-prefill mamba block: carries conv + SSD state across
    chunks."""
    z, xbc, dt = _mix(cfg, p, u)
    new_tail = torch.cat([conv_tail.to(u.dtype), xbc], dim=1)[
        :, -(cfg.ssm_conv - 1):]
    xbc = causal_conv(xbc, p["conv_w"], p["conv_b"], left_context=conv_tail)
    out, final_state = _ssd_out(cfg, p, u, z, xbc, dt, ssm_state)
    return out, final_state, new_tail


def mamba_decode_step(
    cfg: ModelConfig,
    p: Tensors,
    u_t: torch.Tensor,
    ssm_state: torch.Tensor,
    conv_tail: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One-token step. u_t [B, D]; ssm_state [B,H,P,N]; conv_tail
    [B,W-1,Ch]. Returns (out [B, D], new ssm_state, new conv_tail)."""
    dtype = u_t.dtype
    h, pd, g, n = cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_groups, cfg.ssm_state
    z, xbc_t, dt = _mix(cfg, p, u_t[:, None])
    z, xbc_t, dt = z[:, 0], xbc_t[:, 0], dt[:, 0]
    conv_out, conv_tail = conv_decode_step(conv_tail, xbc_t, p["conv_w"],
                                           p["conv_b"])
    xs, bb, cc = torch.split(conv_out, [cfg.d_inner, g * n, g * n], dim=-1)
    b = u_t.shape[0]
    dt = F.softplus(dt.float() + p["dt_bias"])  # [B,H]
    A = -torch.exp(p["A_log"])
    xs = xs.reshape(b, h, pd)
    y, ssm_state = ssd_decode_step(xs, dt, A, bb.reshape(b, g, n),
                                   cc.reshape(b, g, n), ssm_state)
    y = y + p["D"].to(dtype)[None, :, None] * xs
    y = gated_rmsnorm(y.reshape(b, cfg.d_inner), z, p["norm"], cfg.norm_eps)
    out = torch.einsum("bk,kd->bd", y, p["out_proj"].to(dtype))
    return u_t + out, ssm_state, conv_tail


def init_mamba_state(cfg: ModelConfig, batch: int, dtype,
                     device="cpu") -> Dict[str, torch.Tensor]:
    """Per-layer recurrent state template (stacked over layers by
    callers)."""
    conv_ch = cfg.d_inner + 2 * cfg.ssm_groups * cfg.ssm_state
    return {
        "ssm": torch.zeros((batch, cfg.ssm_heads, cfg.ssm_head_dim,
                            cfg.ssm_state), dtype=dtype, device=device),
        "conv": torch.zeros((batch, cfg.ssm_conv - 1, conv_ch), dtype=dtype,
                            device=device),
    }


__all__ = ["MambaBlock", "SSD_SPAN", "segsum", "ssd_chunked",
           "ssd_decode_step", "causal_conv", "conv_decode_step",
           "gated_rmsnorm", "mamba_block", "mamba_block_chunk",
           "mamba_decode_step", "init_mamba_state"]

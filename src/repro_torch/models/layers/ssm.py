"""Mamba-2 (SSD / state-space duality) mixer (port of
``repro/models/layers/ssm.py``).

Prefill runs the chunked SSD algorithm (intra-chunk quadratic
attention-like block as einsums, inter-chunk linear state recurrence as
a Python loop over the ``S / chunk`` chunks: the reference's
``lax.scan``); decode is the O(1) recurrent update.  fp32 state math
throughout, as in the reference.

Layout follows the Mamba-2 reference: in_proj emits [z | x | B | C | dt],
a causal depthwise conv (SiLU after it) runs over [x | B | C], heads of
size P share B/C within ``ssm_ngroups`` groups.  The cache holds the
fp32 state ``[B, H, P, N]`` and the last ``conv_width - 1`` **pre-conv**
inputs; ``ssm_decode`` writes both in place.

Split over ``model`` (the reference's rules: ``ssm_inner`` and
``ssm_heads`` on ``model``), each rank holds a contiguous block of
every leaf, so its bytes are the reference's: a block of ``w_in``'s
packed ``[z | x | B | C | dt]`` columns, which is not its heads' slice.
So each rank gathers the projection (``_Local``), takes its heads'
``z``, ``x`` and ``dt`` and the shared ``B`` / ``C``, runs the conv over
those columns only (with the gathered ``conv_w``) and the SSD over its
heads, takes the gated norm's mean square over the whole ``d_in`` (one
all-reduce of the partial sums of squares) and hands the row-split
``w_out``'s partial sums to ``sharding.block_out``.  The cache holds its
heads' states and its block of the conv tail's columns.  Where the heads
do not divide over ``model`` (their spec drops it) but another leaf
does, that leaf is gathered whole (``sharding.gather_leaf``) and every
rank runs the mixer whole, as GSPMD runs that layout.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.distributed import sharding as shlib
from repro_torch.models.common import rms_normalize
from repro_torch.models.param import ParamSpec


def _dims(cfg):
    d_in = cfg.d_inner_ssm
    H = cfg.ssm_nheads
    P = cfg.ssm_head_dim
    G = cfg.ssm_ngroups
    N = cfg.ssm_state
    conv_dim = d_in + 2 * G * N
    return d_in, H, P, G, N, conv_dim


def ssm_specs(cfg) -> Dict[str, ParamSpec]:
    D = cfg.d_model
    d_in, H, P, G, N, conv_dim = _dims(cfg)
    return {
        "w_in": ParamSpec((D, 2 * d_in + 2 * G * N + H), ("embed", "ssm_inner")),
        "conv_w": ParamSpec((cfg.conv_width, conv_dim), ("conv", "ssm_inner")),
        "conv_b": ParamSpec((conv_dim,), ("ssm_inner",), init="zeros"),
        "a_log": ParamSpec((H,), ("ssm_heads",), init="zeros"),
        "d_skip": ParamSpec((H,), ("ssm_heads",), init="ones"),
        "dt_bias": ParamSpec((H,), ("ssm_heads",), init="zeros"),
        "norm": ParamSpec((d_in,), ("ssm_inner",), init="ones"),
        "w_out": ParamSpec((d_in, D), ("ssm_inner", "embed")),
    }


def _split_proj(proj, cfg):
    d_in, H, P, G, N, _ = _dims(cfg)
    z = proj[..., :d_in]
    x = proj[..., d_in : 2 * d_in]
    Bv = proj[..., 2 * d_in : 2 * d_in + G * N]
    Cv = proj[..., 2 * d_in + G * N : 2 * d_in + 2 * G * N]
    dt = proj[..., 2 * d_in + 2 * G * N :]
    return z, x, Bv, Cv, dt


def conv_tail(x: torch.Tensor, width: int) -> torch.Tensor:
    """The last ``width - 1`` pre-conv inputs of x [B,S,C] (the decode
    cache's ``conv``), left-padded with zeros when S is shorter."""
    S = x.shape[1]
    if S >= width - 1:
        return x[:, S - (width - 1):]
    return F.pad(x, (0, 0, width - 1 - S, 0))


def causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv (no activation). x: [B,S,Cc]; w: [W,Cc]."""
    W, S = w.shape[0], x.shape[1]
    xp = F.pad(x, (0, 0, W - 1, 0))
    out = torch.zeros_like(x)
    for i in range(W):  # small static width (4), the reference's order
        out = out + xp[:, i : i + S] * w[i]
    return out + b


def _segsum(dA: torch.Tensor) -> torch.Tensor:
    """dA: [..., Q] -> L [..., Q, Q]: L[i,j] = sum_{j<k<=i} dA[k], -inf above diag."""
    Q = dA.shape[-1]
    cs = torch.cumsum(dA, dim=-1)
    diff = cs[..., :, None] - cs[..., None, :]  # [.., i, j] = cs_i - cs_j
    mask = torch.tril(torch.ones((Q, Q), dtype=torch.bool, device=dA.device))
    return torch.where(mask, diff, torch.full_like(diff, float("-inf")))


def ssd_chunked(xh, dt, A, Bv, Cv, init_state, chunk: int):
    """Chunked SSD scan.

    xh: [B,S,H,P]; dt: [B,S,H] (post-softplus); A: [H] (negative);
    Bv, Cv: [B,S,G,N]; init_state: [B,H,P,N].
    Returns (y [B,S,H,P], final_state [B,H,P,N]).  fp32 internally.  S
    is padded to a multiple of ``Q = min(chunk, S)`` with ``dt = 0``
    (padded steps neither decay nor feed the state)."""
    Bt, S, H, P = xh.shape
    G, N = Bv.shape[2], Bv.shape[3]
    hpg = H // G
    Q = min(chunk, S)
    pad = (-S) % Q
    if pad:
        xh = F.pad(xh, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        Bv = F.pad(Bv, (0, 0, 0, 0, 0, pad))
        Cv = F.pad(Cv, (0, 0, 0, 0, 0, pad))
    nc = (S + pad) // Q

    f32 = torch.float32
    xh = xh.to(f32).reshape(Bt, nc, Q, H, P)
    dt = dt.to(f32).reshape(Bt, nc, Q, H)
    Bv = Bv.to(f32).reshape(Bt, nc, Q, G, N)
    Cv = Cv.to(f32).reshape(Bt, nc, Q, G, N)
    dA = dt * A.to(f32)  # [B,nc,Q,H]
    dx = xh * dt[..., None]  # dt-weighted input

    # ---- intra-chunk ("diagonal") term: quadratic within chunk ----------
    L = torch.exp(_segsum(dA.transpose(-1, -2)))  # [B,nc,H,Q,Q]
    # scores[b,c,g,q,k] = C_q . B_k  (shared within group)
    scores = torch.einsum("bcqgn,bckgn->bcgqk", Cv, Bv)
    scores = scores[:, :, :, None].expand(Bt, nc, G, hpg, Q, Q).reshape(
        Bt, nc, H, Q, Q)  # expand groups -> heads
    y_diag = torch.einsum("bchqk,bchqk,bckhp->bcqhp", scores, L, dx)

    # ---- chunk-final local states ---------------------------------------
    cums = torch.cumsum(dA, dim=2)  # [B,nc,Q,H]
    decay_to_end = torch.exp(cums[:, :, -1:, :] - cums)  # [B,nc,Q,H]
    # broadcast group-shared B to heads: [B,nc,Q,H,N]
    Bh = Bv[:, :, :, :, None].expand(Bt, nc, Q, G, hpg, N).reshape(Bt, nc, Q, H, N)
    # state_c = sum_k B_k (decay_k dx_k)   -> [B,nc,H,P,N]
    states = torch.einsum("bckhn,bckh,bckhp->bchpn", Bh, decay_to_end, dx)

    # ---- inter-chunk recurrence (the reference's lax.scan) ---------------
    chunk_decay = torch.exp(cums[:, :, -1, :])  # [B,nc,H]
    carry = init_state.to(f32)
    prev = []
    for c in range(nc):
        prev.append(carry)  # the *incoming* state of chunk c
        carry = carry * chunk_decay[:, c, :, None, None] + states[:, c]
    prev_states = torch.stack(prev, dim=1)  # [B,nc,H,P,N]

    # ---- off-diagonal (cross-chunk) output term --------------------------
    decay_from_start = torch.exp(cums)  # [B,nc,Q,H]
    Ch = Cv[:, :, :, :, None].expand(Bt, nc, Q, G, hpg, N).reshape(Bt, nc, Q, H, N)
    y_off = torch.einsum("bcqhn,bcqh,bchpn->bcqhp", Ch, decay_from_start,
                         prev_states)

    y = (y_diag + y_off).reshape(Bt, nc * Q, H, P)[:, :S]
    return y, carry


class _Local:
    """This rank's share of a Mamba-2 mixer: its heads ``[h0, h0 + H)``
    of ``H_all``, their groups, and the collectives of the split (all
    identities when the mixer is whole)."""

    def __init__(self, params, cfg):
        d_in, H, P, G, N, conv_dim = _dims(cfg)
        h_loc = params["a_log"].shape[0]
        self.split = shlib.model_split(h_loc, H)
        self.n, self.r = 1, 0
        # (dimension, whole size) of the leaves split with the heads
        full = {"w_in": (1, 2 * d_in + 2 * G * N + H), "conv_w": (1, conv_dim),
                "conv_b": (0, conv_dim), "norm": (0, d_in), "w_out": (0, d_in)}
        #: the leaves a whole mixer gathers (heads whole, the leaf split)
        self.gathered = {} if self.split else {
            k: v for k, v in full.items() if params[k].shape[v[0]] != v[1]}
        if self.split:
            mesh, _ = shlib.active_rules()
            self.n, self.r = mesh.extent("model"), mesh.coord("model")
            bad = {k: v for k, v in full.items()
                   if params[k].shape[v[0]] * self.n != v[1]}
            hpg = H // G
            if bad or (G > 1 and h_loc % hpg):
                raise NotImplementedError(
                    f"{cfg.name}: the SSM mixer's heads split over 'model' "
                    f"({self.n}) but not {sorted(bad) or 'its groups'}: every "
                    f"leaf's split must divide (ROADMAP, Queue A item 4)")
        self.H, self.h0 = h_loc, self.r * h_loc
        hpg = H // G
        self.g0 = self.h0 // hpg
        self.G = max(1, h_loc // hpg)
        self.cfg = cfg

    def cols(self, device) -> torch.Tensor:
        """This rank's columns of the conv's ``[x | B | C]``: its heads'
        ``x`` and its groups' ``B`` and ``C``."""
        d_in, H, P, G, N, _ = _dims(self.cfg)
        x = torch.arange(self.h0 * P, (self.h0 + self.H) * P)
        gb = torch.arange(self.g0 * N, (self.g0 + self.G) * N)
        return torch.cat([x, d_in + gb, d_in + G * N + gb]).to(device)

    def params(self, params: Dict) -> Dict:
        """``params`` with the ``gathered`` leaves whole."""
        if not self.gathered:
            return params
        return dict(params, **{k: shlib.gather_leaf(params[k], d)
                               for k, (d, _) in self.gathered.items()})

    def whole(self, t: torch.Tensor, d: int, full: int) -> torch.Tensor:
        """``t``'s dimension ``d`` gathered over ``model`` where it holds a
        block of ``full`` (the backward keeps the block of the summed
        gradient)."""
        if t.shape[d] == full:
            return t
        return shlib.gather([t], [d], "model")[0]


def _gated_out(params, y, z, x, loc: "_Local" = None):
    """Gated RMSNorm (mamba2): norm(y * silu(z)) * scale, then out-proj;
    split over ``model``, the mean square is over the whole ``d_in``
    (the ranks' sums of squares all-reduced) and the out-projection's
    partial sums go to ``sharding.block_out``."""
    if loc is None or not loc.split:
        y = rms_normalize(y * F.silu(z)) * params["norm"].to(x.dtype)
        out = y @ params["w_out"]
        return out if loc is None or shlib.active_rules()[0] is None \
            else shlib.block_out(out, False)
    v = y * F.silu(z)
    vf = v.float()
    ss = shlib.enter(shlib.reduce(vf.square().sum(dim=-1, keepdim=True),
                                  "model"), "model")
    ms = ss / (vf.shape[-1] * loc.n)
    y = (vf * torch.rsqrt(ms + 1e-6)).to(v.dtype) * params["norm"].to(x.dtype)
    return shlib.block_out(y @ params["w_out"])


def _heads_proj(params, x: torch.Tensor, cfg, loc: "_Local"):
    """x -> (z, x [B,S,H_loc*P], B, C [B,S,G_loc*N], dt [B,S,H_loc]) of this
    rank's heads and groups, and the whole ``[x | B | C]`` (pre-conv)."""
    d_in, H, P, G, N, _ = _dims(cfg)
    if loc.split:
        x = shlib.block_in(x)
    width = 2 * d_in + 2 * G * N + H
    proj = loc.whole(x @ params["w_in"], x.dim() - 1, width)
    z, xc, Bv, Cv, dt = _split_proj(proj, cfg)
    xbc = torch.cat([xc, Bv, Cv], dim=-1)
    if not loc.split:
        return z, xbc, dt, xbc
    hs = slice(loc.h0 * P, (loc.h0 + loc.H) * P)
    sel = xbc.index_select(-1, loc.cols(x.device))
    return z[..., hs], sel, dt[..., loc.h0: loc.h0 + loc.H], xbc


def _conv_params(params, cfg, loc: "_Local"):
    """``conv_w`` / ``conv_b`` of this rank's conv columns."""
    *_, conv_dim = _dims(cfg)
    if not loc.split:
        return params["conv_w"], params["conv_b"]
    w = loc.whole(params["conv_w"], 1, conv_dim)
    b = loc.whole(params["conv_b"], 0, conv_dim)
    cols = loc.cols(w.device)
    return w.index_select(1, cols), b.index_select(0, cols)


def ssm_forward(params: Dict, x: torch.Tensor, cfg, init_state=None
                ) -> Tuple[torch.Tensor, Dict]:
    """Full-sequence Mamba-2 mixer. x: [B,S,D] -> (y [B,S,D], cache
    material ``{state [B,H,P,N] fp32, conv [B,W-1,conv_dim]}``; split over
    ``model``: this rank's heads' states and the whole conv tail)."""
    B, S, D = x.shape
    d_in, H, P, G, N, conv_dim = _dims(cfg)
    loc = _Local(params, cfg)
    params = loc.params(params)
    z, xbc, dt, pre = _heads_proj(params, x, cfg, loc)
    tail = conv_tail(pre, cfg.conv_width)
    cw, cb = _conv_params(params, cfg, loc)
    xbc = F.silu(causal_conv(xbc, cw, cb))
    h_in, g_n = loc.H * P, loc.G * N
    xc = xbc[..., :h_in].reshape(B, S, loc.H, P)
    Bv = xbc[..., h_in : h_in + g_n].reshape(B, S, loc.G, N)
    Cv = xbc[..., h_in + g_n :].reshape(B, S, loc.G, N)

    f32 = torch.float32
    dt = F.softplus(dt.to(f32) + params["dt_bias"].to(f32))
    A = -torch.exp(params["a_log"].to(f32))
    if init_state is None:
        init_state = torch.zeros((B, loc.H, P, N), dtype=f32, device=x.device)
    y, state = ssd_chunked(xc, dt, A, Bv, Cv, init_state, cfg.ssm_chunk)
    y = y + xc.to(f32) * params["d_skip"].to(f32)[:, None]
    y = y.reshape(B, S, h_in).to(x.dtype)
    return _gated_out(params, y, z, x, loc), {"state": state, "conv": tail}


def ssm_cache_specs(cfg, batch: int) -> Dict[str, ParamSpec]:
    d_in, H, P, G, N, conv_dim = _dims(cfg)
    return {
        "state": ParamSpec((batch, H, P, N),
                           ("batch", "ssm_heads", None, "ssm_state"),
                           init="zeros", dtype="float32"),
        "conv": ParamSpec((batch, cfg.conv_width - 1, conv_dim),
                          ("batch", "conv", "ssm_inner"), init="zeros"),
    }


def ssm_decode(params: Dict, cache: Dict, x: torch.Tensor, cfg
               ) -> Tuple[torch.Tensor, Dict]:
    """Single-token recurrent update. x: [B,1,D].  The cache's ``state``
    and ``conv`` are advanced **in place** (the reference returns new
    ones): a caller that runs two steps from one cache must restore
    them in between (``evaluate.classification_sim``)."""
    B = x.shape[0]
    d_in, H, P, G, N, conv_dim = _dims(cfg)
    loc = _Local(params, cfg)
    params = loc.params(params)
    z, _, dt, xbc_new = _heads_proj(params, x, cfg, loc)  # [B,1,conv_dim]

    # conv window: cache["conv"] holds the previous W-1 inputs (split:
    # this rank's block of their columns)
    tail = loc.whole(cache["conv"], 2, conv_dim)
    win = torch.cat([tail.to(x.dtype), xbc_new], dim=1)
    cw, cb = _conv_params(params, cfg, loc)
    if loc.split:
        win_sel = win.index_select(-1, loc.cols(x.device))
    else:
        win_sel = win
    conv_out = torch.einsum("bwc,wc->bc", win_sel, cw) + cb
    xbc = F.silu(conv_out)[:, None]  # [B,1,H_loc*P + 2*G_loc*N]

    Hl, h_in, g_n, Gl = loc.H, loc.H * P, loc.G * N, loc.G
    xh = xbc[..., :h_in].reshape(B, Hl, P)
    Bv = xbc[..., h_in : h_in + g_n].reshape(B, Gl, N)
    Cv = xbc[..., h_in + g_n :].reshape(B, Gl, N)
    hpg = Hl // Gl
    Bh = Bv[:, :, None].expand(B, Gl, hpg, N).reshape(B, Hl, N)
    Ch = Cv[:, :, None].expand(B, Gl, hpg, N).reshape(B, Hl, N)

    f32 = torch.float32
    dt = F.softplus(dt.to(f32)[:, 0] + params["dt_bias"].to(f32))  # [B,H]
    A = -torch.exp(params["a_log"].to(f32))
    dA = torch.exp(dt * A)  # [B,H]
    dx = xh.to(f32) * dt[..., None]  # [B,H,P]
    state = cache["state"].to(f32) * dA[..., None, None] \
        + torch.einsum("bhp,bhn->bhpn", dx, Bh.to(f32))
    y = torch.einsum("bhpn,bhn->bhp", state, Ch.to(f32))
    y = y + xh.to(f32) * params["d_skip"].to(f32)[:, None]
    y = y.reshape(B, 1, h_in).to(x.dtype)
    out = _gated_out(params, y, z, x, loc)
    cache["state"].copy_(state)
    w = cache["conv"].shape[2]
    if w != conv_dim:  # this rank's block of the tail's columns
        win = win.narrow(2, shlib.active_rules()[0].coord("model") * w, w)
    cache["conv"].copy_(win[:, 1:])
    return out, cache

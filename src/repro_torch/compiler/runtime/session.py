"""Decode sessions: resident weights + live KV/state over an executor,
on torch tensors.

The counterpart of ``repro.compiler.runtime.session``. An
autoregressive decode invocation is not one program run — it is a
*session*: weights are bound once and stay resident, each
``step(token, pos)`` executes the per-token step program against live
cache buffers, and only the first invocation pays for the weight DMAs
(``compiler/lower.py`` decorate_decode / steady_program pair).

Two session flavors share all the inter-GEMM glue (embedding lookup,
causal attention over the KV cache, SiLU-gated MLPs and MoE routing,
the diagonal SSM recurrence, inter-unit requantization):

  * :class:`ExecutorSession` — drives a compiled backend
    (``CudaExecutor`` or ``GoldenExecutor`` over a decorated
    :class:`~repro_torch.compiler.program.Program`). The first step
    runs the warm-up program (weight fetches included); every later
    step runs the steady-state program whose weight fetches are elided
    — the golden backend's contract checks then *prove* no weight DMA
    is re-issued.
  * :class:`ReferenceSession` — the plain ``decode_step`` reference:
    whole-layer ``kernels/ref.py`` GEMMs (no tiling, no ISA walk, no
    kernel) through the identical glue. Bit-exactness of an
    ExecutorSession against this reference, on one device, is the
    decode analogue of the executor-vs-oracle parity tests.

The glue models the *functional* shape of a decode step over the
compiled projection GEMMs — causal softmax attention with GQA over an
int-coded KV cache, SiLU-gated MLPs, softmax-weighted MoE experts, a
gated diagonal SSM recurrence — but no norms or residual adds: the
reference and the sessions apply exactly the same glue, so parity is
meaningful without modeling the full model frontends.

Every tensor of a session lives on its ``device`` (``cuda`` unless the
caller asks for the CPU). Caches and SSM states are updated in place.
Every division by a scale divides by a device tensor (IEEE division on
every device; CUDA multiplies by the reciprocal of a host scalar), and
the glue's fp32 einsums run at full precision: no TF32 flag is read or
set here, and torch's default keeps TF32 off for fp32 matmuls.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.quant.uniform import _inv_hi, fit_scale, qrange
from repro_torch.kernels import ops as kops
from repro_torch.kernels import ref as kref
from repro_torch.compiler.lower import steady_program
from repro_torch.compiler.runtime.base import (
    ExecutionError,
    LayerWeights,
    requantize,
    requantize_rows,
    resolve_device,
    synthetic_weights,
)


@dataclasses.dataclass(frozen=True)
class _Unit:
    """One glue unit of the decode step: a run of consecutive layers
    (attention q/k/v/o, MLP gate/up/down, MoE router+experts, SSM
    in/out projections, or the lm head) plus the glue between them."""
    kind: str                  # "attn" | "mlp" | "moe" | "ssm" | "head"
    idxs: tuple[int, ...]


def _block_plan(layers) -> list[_Unit]:
    """Group a decode program's layer list into glue units by the
    naming convention of ``compiler/networks.py``."""
    units: list[_Unit] = []
    i, n = 0, len(layers)
    while i < n:
        name = layers[i].name
        if name == "lm_head":
            units.append(_Unit("head", (i,)))
            i += 1
        elif name.endswith(".attn.q"):
            units.append(_Unit("attn", tuple(range(i, i + 4))))
            i += 4
        elif name.endswith(".ssm.in_zx"):
            units.append(_Unit("ssm", tuple(range(i, i + 4))))
            i += 4
        elif name.endswith(".mlp.gate"):
            units.append(_Unit("mlp", tuple(range(i, i + 3))))
            i += 3
        elif name.endswith(".mlp.router"):
            idxs = [i]
            i += 1
            while i < n and (".mlp.e" in layers[i].name
                             or ".mlp.shared." in layers[i].name):
                idxs.append(i)
                i += 1
            units.append(_Unit("moe", tuple(idxs)))
        else:
            raise ExecutionError(
                f"decode session cannot place layer {name!r} in a glue "
                f"unit (attn/mlp/moe/ssm/head naming expected)")
    return units


def _quant_with_scale(x: torch.Tensor, bits: int):
    """``requantize`` that also returns the max-abs scale — cache rows
    are stored as integer codes (what the KV segment bytes hold) with
    their per-step dequant scale alongside."""
    s = fit_scale(x, bits)
    lo, hi = qrange(bits)
    return torch.clamp(torch.round(x / s), lo, hi).to(torch.int8), s


def _quant_rows_with_scale(x: torch.Tensor, bits: int):
    """Per-row twin of :func:`_quant_with_scale` (one scale per batch
    row, bit-identical to it at batch 1) for per-slot KV appends."""
    s = torch.clamp(x.abs().amax(dim=-1), min=1e-8) * _inv_hi(bits)
    lo, hi_q = qrange(bits)
    q = torch.clamp(torch.round(x / s[:, None]), lo, hi_q).to(torch.int8)
    return q, s


def synthetic_decode_arrays(layers, spec, seed: int | None = None
                            ) -> dict:
    """The exact arrays :meth:`DecodeSession.bind_synthetic_all` binds,
    as a flat name->ndarray dict (``L{i}.w_lut`` / ``L{i}.s_lut`` /
    ``L{i}.w_dsp`` / ``L{i}.s_dsp`` + ``embed``).

    The reference's generator and draws, so both packages bind
    byte-identical weight segments for the same seed.
    """
    out: dict = {}
    for lp in layers:
        w_lut, s_lut, w_dsp, s_dsp = synthetic_weights(
            lp.index, lp.dims.k, lp.n_lut, lp.dims.n - lp.n_lut,
            lp.bits_w_lut, None if seed is None else seed + lp.index)
        for name, arr in (("w_lut", w_lut), ("s_lut", s_lut),
                          ("w_dsp", w_dsp), ("s_dsp", s_dsp)):
            if arr is not None:
                out[f"L{lp.index}.{name}"] = np.asarray(arr)
    bits = layers[0].bits_a
    vocab = layers[-1].dims.n
    rng = np.random.default_rng(10_000 + (seed or 0))
    lo, hi = qrange(bits)
    out["embed"] = rng.integers(lo, hi + 1, (vocab, spec.d_model))
    return out


def _on(a, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """A numpy array, Python scalar/list or tensor as ``dtype`` on
    ``device``."""
    if not isinstance(a, torch.Tensor):
        a = torch.as_tensor(np.asarray(a))
    return a.to(device=device, dtype=dtype)


class DecodeSession:
    """Shared decode-step state machine (glue + caches + embedding).

    Subclasses implement :meth:`_run_layer` (how one projection GEMM is
    computed) and :meth:`bind_layer`. ``step(token, pos)`` embeds the
    token, walks the glue units, and returns fp32 logits [batch,
    padded_vocab]; caches/state advance in place.
    """

    #: subclass tag used in tracer span names ("ref", "golden", ...)
    session_name = "base"

    def __init__(self, layers, spec, name: str, tracer=None,
                 device="cuda"):
        if spec is None:
            raise ExecutionError(
                f"{name}: program carries no StepSpec — compile it in "
                f"decode mode (lower_network(step=...))")
        if tracer is None:
            from repro_torch.obs import NULL_TRACER
            tracer = NULL_TRACER
        self.tracer = tracer
        self.device = resolve_device(device)
        self.layers = list(layers)
        self.spec = spec
        self.program_name = name
        self.units = _block_plan(self.layers)
        self.pos = 0
        self.per_slot = False
        self._embed_table = None
        self._caches: dict[int, dict[str, torch.Tensor]] = {}
        # the attention score divisor as a device tensor (see the
        # module docstring on divisions)
        self._sqrt_hd = torch.tensor(math.sqrt(max(spec.head_dim, 1)),
                                     dtype=torch.float32, device=self.device)
        self.reset()

    # -- session state -----------------------------------------------------

    def reset(self, per_slot: bool | None = None) -> None:
        """Clear the KV caches / SSM states and rewind to position 0.
        Bound weights stay resident (a new sequence, not a new model).

        ``per_slot=True`` switches the session to slot-batched serving:
        the KV quant scales become per-slot (``[max_seq, batch]``
        instead of ``[max_seq]``) so each batch row can hold an
        unrelated request at its own position (:meth:`step_slots`),
        with :meth:`reset_slot` recycling one row for a new request.
        """
        if per_slot is not None:
            self.per_slot = bool(per_slot)
        S, B = self.spec.max_seq, self.spec.batch
        self.pos = 0
        self._caches = {}
        scale_shape = (S, B) if self.per_slot else (S,)
        dev = self.device
        for u_i, unit in enumerate(self.units):
            if unit.kind == "attn":
                n_kv = self.layers[unit.idxs[1]].dims.n
                self._caches[u_i] = {
                    "k": torch.zeros((S, B, n_kv), dtype=torch.int8,
                                     device=dev),
                    "v": torch.zeros((S, B, n_kv), dtype=torch.int8,
                                     device=dev),
                    "ks": torch.zeros(scale_shape, dtype=torch.float32,
                                      device=dev),
                    "vs": torch.zeros(scale_shape, dtype=torch.float32,
                                      device=dev),
                }
            elif unit.kind == "ssm":
                d_inner = self.layers[unit.idxs[3]].dims.k
                self._caches[u_i] = {
                    "state": torch.zeros((B, d_inner), dtype=torch.float32,
                                         device=dev)}

    def reset_slot(self, slot: int) -> None:
        """Recycle one batch row for a newly admitted request: zero its
        KV cache columns, quant scales and SSM state rows. The other
        slots' in-flight requests are untouched (continuous batching
        admits at step boundaries without draining the batch)."""
        if not self.per_slot:
            raise ExecutionError(
                "reset_slot needs per-slot mode (reset(per_slot=True))")
        if not 0 <= slot < self.spec.batch:
            raise ExecutionError(
                f"slot {slot} outside [0, {self.spec.batch})")
        for u_i, unit in enumerate(self.units):
            c = self._caches.get(u_i)
            if unit.kind == "attn":
                for key in ("k", "v", "ks", "vs"):
                    c[key][:, slot] = 0
            elif unit.kind == "ssm":
                c["state"][slot] = 0.0

    def bind_embedding(self, table) -> None:
        """Bind the token-embedding code table [vocab, d_model] int8
        (codes at the first layer's ``bits_a``)."""
        table = _on(table, torch.int8, self.device)
        if table.ndim != 2 or table.shape[1] != self.spec.d_model:
            raise ExecutionError(
                f"embedding table must be [vocab, {self.spec.d_model}], "
                f"got {tuple(table.shape)}")
        self._embed_table = table

    def bind_synthetic_all(self, seed: int | None = None) -> None:
        """Bind deterministic synthetic weights for every layer plus a
        synthetic embedding table — the same generation for every
        session flavor, so parity tests compare identical models."""
        self.bind_arrays(
            synthetic_decode_arrays(self.layers, self.spec, seed))

    def bind_arrays(self, arrays: dict) -> None:
        """Bind every layer + the embedding table from a flat
        name->array dict (the :func:`synthetic_decode_arrays` layout)."""
        for lp in self.layers:
            self.bind_layer(
                lp.index,
                w_lut=arrays.get(f"L{lp.index}.w_lut"),
                s_lut=arrays.get(f"L{lp.index}.s_lut"),
                w_dsp=arrays.get(f"L{lp.index}.w_dsp"),
                s_dsp=arrays.get(f"L{lp.index}.s_dsp"))
        self.bind_embedding(arrays["embed"])

    # -- the decode step ---------------------------------------------------

    def step(self, token, pos: int | None = None) -> torch.Tensor:
        """Run one decode step: embed ``token`` ([batch] integers or a
        scalar; a tensor on the session's device stays there), advance
        the caches at ``pos`` (default: the session's running position)
        and return fp32 logits [batch, vocab]."""
        if self.per_slot:
            raise ExecutionError(
                "scalar step() on a per-slot session — use "
                "step_slots(tokens, pos) or reset(per_slot=False)")
        pos = self.pos if pos is None else int(pos)
        if not 0 <= pos < self.spec.max_seq:
            raise ExecutionError(
                f"step position {pos} outside the session's "
                f"[0, {self.spec.max_seq}) cache window")
        x = self._embed_tokens(token)
        logits = None
        for u_i, unit in enumerate(self.units):
            out = self._run_unit(u_i, unit, x, pos)
            if unit.kind == "head":
                logits = out
                break
            nxt = self.units[u_i + 1]
            x = requantize(out, self.layers[nxt.idxs[0]].bits_a)
        self.pos = pos + 1
        return logits

    def step_slots(self, tokens, pos) -> torch.Tensor:
        """One continuous-batching step: slot ``j`` embeds ``tokens[j]``
        and advances its caches at its own ``pos[j]``.

        The slot-batched twin of :meth:`step`: every reduction that
        :meth:`step` takes per tensor (inter-unit requant scales, KV
        quant scales, the causal mask, cache appends) is taken per
        batch row here, so slot ``j``'s logits are bit-identical to a
        batch-1 session serving that request alone. Requires
        ``reset(per_slot=True)``; the caller owns per-slot positions
        (``self.pos`` does not advance).
        """
        if not self.per_slot:
            raise ExecutionError(
                "step_slots needs per-slot mode (reset(per_slot=True))")
        B = self.spec.batch
        pos_arr = np.asarray(pos, np.int64).reshape(-1)
        if pos_arr.shape[0] != B:
            raise ExecutionError(
                f"step_slots pos must be [{B}], got {pos_arr.shape}")
        if pos_arr.min() < 0 or pos_arr.max() >= self.spec.max_seq:
            raise ExecutionError(
                f"slot positions {pos_arr.tolist()} outside the "
                f"session's [0, {self.spec.max_seq}) cache window")
        pos_v = torch.as_tensor(pos_arr).to(self.device)
        x = self._embed_tokens(tokens)
        for u_i, unit in enumerate(self.units):
            if unit.kind == "head":
                return self._run_layer(unit.idxs[0], x)
            if unit.kind == "attn":
                out = self._attn_unit_slots(u_i, unit, x, pos_v)
            elif unit.kind == "ssm":
                out = self._ssm_unit_slots(u_i, unit, x)
            elif unit.kind == "mlp":
                out = self._mlp_rows(unit.idxs, x)
            else:
                out = self._moe_unit_slots(unit, x)
            nxt = self.units[u_i + 1]
            x = requantize_rows(out, self.layers[nxt.idxs[0]].bits_a)
        return None

    def _embed_tokens(self, token) -> torch.Tensor:
        B = self.spec.batch
        tok = _on(token, torch.int64, self.device).reshape(-1)
        if tok.shape[0] == 1 and B > 1:
            tok = tok.expand(B)
        if tok.shape[0] != B:
            raise ExecutionError(
                f"step token must be scalar or [{B}], got "
                f"{tuple(tok.shape)}")
        if self._embed_table is None:
            raise ExecutionError(
                "no embedding table bound (bind_embedding / "
                "bind_synthetic_all)")
        # the reference's gather clamps a token past the table to its
        # last row (a negative one counts from the end first), as JAX
        # indexing does; the launcher feeds the full vocabulary's
        # prompts to the smoke decode program's table
        vocab = self._embed_table.shape[0]
        tok = torch.where(tok < 0, tok + vocab, tok).clamp(0, vocab - 1)
        return self._embed_table[tok]

    # -- glue units --------------------------------------------------------

    def _run_unit(self, u_i: int, unit: _Unit, x_q, pos: int):
        if unit.kind == "head":
            return self._run_layer(unit.idxs[0], x_q)
        if unit.kind == "attn":
            return self._attn_unit(u_i, unit, x_q, pos)
        if unit.kind == "ssm":
            return self._ssm_unit(u_i, unit, x_q)
        if unit.kind == "mlp":
            return self._mlp(unit.idxs, x_q)
        return self._moe_unit(unit, x_q)

    def _mlp(self, idxs, x_q):
        ig, iu, idn = idxs
        h = F.silu(self._run_layer(ig, x_q)) * self._run_layer(iu, x_q)
        return self._run_layer(idn, requantize(h, self.layers[idn].bits_a))

    def _moe_split(self, unit: _Unit):
        """The routed expert triples and the shared triple (or None)."""
        experts, shared = [], None
        for j in range(1, len(unit.idxs), 3):
            triple = unit.idxs[j:j + 3]
            if ".mlp.shared." in self.layers[triple[0]].name:
                shared = triple
            else:
                experts.append(triple)
        return experts, shared

    def _moe_unit(self, unit: _Unit, x_q, mlp=None):
        mlp = self._mlp if mlp is None else mlp
        router_logits = self._run_layer(unit.idxs[0], x_q)
        experts, shared = self._moe_split(unit)
        # the compiled program carries the top_k routed experts as
        # static layers e0..e{k-1} (the compute that fires per token);
        # weight them by the router's softmax renormalized over them
        w = torch.softmax(router_logits, dim=-1)[:, :len(experts)]
        w = w / torch.sum(w, dim=-1, keepdim=True)
        out = torch.zeros((self.spec.batch, self.spec.d_model),
                          dtype=torch.float32, device=self.device)
        for e, triple in enumerate(experts):
            out = out + w[:, e:e + 1] * mlp(triple, x_q)
        if shared is not None:
            out = out + mlp(shared, x_q)
        return out

    def _attn_unit(self, u_i: int, unit: _Unit, x_q, pos: int):
        iq, ik, iv, io = unit.idxs
        q = self._run_layer(iq, x_q)
        k = self._run_layer(ik, x_q)
        v = self._run_layer(iv, x_q)
        c = self._caches[u_i]
        bits_kv = self.layers[ik].bits_a
        kq, ks = _quant_with_scale(k, bits_kv)
        vq, vs = _quant_with_scale(v, bits_kv)
        self._cache_set(c["k"], kq, pos)
        self._cache_set(c["v"], vq, pos)
        c["ks"][pos] = ks
        c["vs"][pos] = vs
        ctx = self._attn_ctx(q, c, torch.arange(
            c["k"].shape[0], device=self.device)[None, None, :] <= pos)
        return self._run_layer(io, requantize(ctx, self.layers[io].bits_a))

    def _attn_ctx(self, q, cache, mask):
        """Causal GQA softmax attention over the coded KV cache;
        ``mask`` [1 or batch, 1, max_seq] marks the positions each row
        attends to. A per-tensor scale cache ``[max_seq]`` dequantizes
        every row alike, a per-slot one ``[max_seq, batch]`` row by
        row."""
        spec = self.spec
        B, hq, hkv, hd = spec.batch, spec.n_heads, spec.n_kv_heads, \
            spec.head_dim
        S = cache["k"].shape[0]
        ks, vs = cache["ks"], cache["vs"]
        if ks.ndim == 1:
            ks, vs = ks[:, None, None], vs[:, None, None]
        else:
            ks, vs = ks[:, :, None], vs[:, :, None]
        kf = cache["k"].to(torch.float32) * ks
        vf = cache["v"].to(torch.float32) * vs
        qh = q.reshape(B, hq, hd)
        kh = kf.reshape(S, B, hkv, hd).repeat_interleave(hq // hkv, dim=2)
        vh = vf.reshape(S, B, hkv, hd).repeat_interleave(hq // hkv, dim=2)
        scores = torch.einsum("bhd,sbhd->bhs", qh, kh) / self._sqrt_hd
        weights = torch.softmax(scores.masked_fill(~mask, -math.inf),
                                dim=-1)
        ctx = torch.einsum("bhs,sbhd->bhd", weights, vh)
        return ctx.reshape(B, hq * hd)

    def _ssm_unit(self, u_i: int, unit: _Unit, x_q, requant=requantize):
        """Gated diagonal recurrence over the persistent fp32 state —
        the in-place-updated analogue of the ``state`` segment the
        decode decoration allocates (batch x d_inner x 4 bytes)."""
        izx, ibc, idt, iout = unit.idxs
        zx = self._run_layer(izx, x_q)
        bc = self._run_layer(ibc, x_q)
        dt = self._run_layer(idt, x_q)
        d_inner = self.layers[iout].dims.k
        z, xin = zx[:, :d_inner], zx[:, d_inner:]
        decay = torch.sigmoid(dt).repeat_interleave(
            d_inner // dt.shape[1], dim=1)
        state = self._caches[u_i]["state"]
        state.mul_(decay).add_((1.0 - decay) * F.silu(xin))
        gate = 1.0 + torch.tanh(torch.mean(bc, dim=-1, keepdim=True))
        y = state * F.silu(z) * gate
        return self._run_layer(iout, requant(y, self.layers[iout].bits_a))

    def _cache_set(self, cache, row, pos: int) -> None:
        cache[pos] = row

    # -- per-slot glue (continuous batching) -------------------------------
    #
    # Row-independent twins of the units above: identical math, but no
    # reduction ever crosses batch rows and each row indexes the caches
    # at its own position. With a single slot they reduce to exactly
    # the scalar-pos path (tested), which is what makes mixed-request
    # batches bit-exact per request.

    def _mlp_rows(self, idxs, x_q):
        ig, iu, idn = idxs
        h = F.silu(self._run_layer(ig, x_q)) * self._run_layer(iu, x_q)
        return self._run_layer(
            idn, requantize_rows(h, self.layers[idn].bits_a))

    def _moe_unit_slots(self, unit: _Unit, x_q):
        return self._moe_unit(unit, x_q, mlp=self._mlp_rows)

    def _attn_unit_slots(self, u_i: int, unit: _Unit, x_q, pos):
        iq, ik, iv, io = unit.idxs
        q = self._run_layer(iq, x_q)
        k = self._run_layer(ik, x_q)
        v = self._run_layer(iv, x_q)
        c = self._caches[u_i]
        bits_kv = self.layers[ik].bits_a
        kq, ks = _quant_rows_with_scale(k, bits_kv)
        vq, vs = _quant_rows_with_scale(v, bits_kv)
        bidx = torch.arange(self.spec.batch, device=self.device)
        c["k"][pos, bidx] = kq
        c["v"][pos, bidx] = vq
        c["ks"][pos, bidx] = ks
        c["vs"][pos, bidx] = vs
        # row b attends to cache positions <= pos[b] and dequantizes
        # with its own per-slot scales
        mask = torch.arange(c["k"].shape[0], device=self.device
                            )[None, None, :] <= pos[:, None, None]
        ctx = self._attn_ctx(q, c, mask)
        return self._run_layer(
            io, requantize_rows(ctx, self.layers[io].bits_a))

    def _ssm_unit_slots(self, u_i: int, unit: _Unit, x_q):
        return self._ssm_unit(u_i, unit, x_q, requant=requantize_rows)

    # -- subclass hooks ----------------------------------------------------

    def _run_layer(self, index: int, x_q) -> torch.Tensor:
        raise NotImplementedError

    def bind_layer(self, index: int, w_lut=None, s_lut=None,
                   w_dsp=None, s_dsp=None) -> None:
        raise NotImplementedError


class ReferenceSession(DecodeSession):
    """The plain ``decode_step`` reference for a compiled decode
    program: whole-layer reference GEMMs (``kernels/ref.py`` bit-serial
    + packed-int4 numerics — no tiling, no instruction walk, no kernel
    launch) through the shared glue, on ``device``. The oracle every
    ExecutorSession on the same device must match bit-exactly."""

    session_name = "ref"

    def __init__(self, program, tracer=None, device="cuda"):
        self._weights: dict[int, LayerWeights] = {}
        super().__init__(program.layers, program.step, program.name,
                         tracer, device)

    def bind_layer(self, index, w_lut=None, s_lut=None,
                   w_dsp=None, s_dsp=None) -> None:
        def as_w(w, s):
            return (_on(w, torch.int32, self.device),
                    _on(s, torch.float32, self.device).reshape(-1))
        wl, sl = as_w(w_lut, s_lut) if w_lut is not None else (None, None)
        wd, sd = as_w(w_dsp, s_dsp) if w_dsp is not None else (None, None)
        self._weights[index] = LayerWeights(wl, sl, wd, sd)

    def _run_layer(self, index, x_q):
        lp = self.layers[index]
        wts = self._weights[index]
        x = _on(x_q, torch.int8, self.device)
        outs = []
        if wts.w_lut is not None:
            outs.append(kref.bitserial_gemm_ref(
                x, wts.w_lut, wts.s_lut, lp.bits_w_lut))
        if wts.w_dsp is not None:
            outs.append(kops.int4_matmul(
                x, wts.w_dsp, wts.s_dsp, mode="ref"))
        return torch.cat(outs, dim=1) if len(outs) > 1 else outs[0]


def decode_step_ref(program, tracer=None, device="cuda") -> ReferenceSession:
    """Convenience constructor for the plain decode reference."""
    return ReferenceSession(program, tracer=tracer, device=device)


class ExecutorSession(DecodeSession):
    """Decode session over compiled backends: bind weights once, then
    ``step(token, pos)`` repeatedly.

    ``program`` is a decode-decorated
    :class:`~repro_torch.compiler.program.Program` (or a decorated
    ``MultiDeviceProgram`` bundle — the session then drives a
    ``MultiDeviceExecutor`` per phase). The first step
    executes the warm-up program (weight DMAs included); later steps
    execute the steady-state variant (``compiler/lower.py
    steady_program``) whose weight fetches are elided — on the golden
    backend the contract checks verify the steady program touches no
    weight segment. Both executors are built on ``device``; on
    ``cuda`` every projection GEMM is a kernel launch (or raises).

    Each step is measured as an ``exec.<backend>.step`` tracer span
    tagged ``phase=warmup|steady``; ``serve.decode.tokens`` counts steps
    in ``obs.METRICS``.
    """

    def __init__(self, program, backend: str | type = "cuda",
                 tracer=None, device="cuda", **backend_kwargs):
        from repro_torch.compiler.partition import (MultiDeviceProgram,
                                                    steady_bundle)
        if isinstance(program, MultiDeviceProgram):
            from repro_torch.compiler.runtime.multi import \
                MultiDeviceExecutor
            spec = program.devices[0].step
            if spec is None:
                raise ExecutionError(
                    f"{program.name}: bundle is not decode-decorated "
                    f"(partition.decorate_decode_bundle)")
            self.steady = steady_bundle(program)
            self._warm_ex = MultiDeviceExecutor(
                program, backend=backend, tracer=tracer, device=device,
                **backend_kwargs)
            self._steady_ex = MultiDeviceExecutor(
                self.steady, backend=backend, tracer=tracer, device=device,
                **backend_kwargs)
            bname = backend if isinstance(backend, str) else backend.name
            self.session_name = f"multi.{bname}"
            layers = self._warm_ex.layers
        else:
            from repro_torch.compiler.runtime import get_backend
            spec = program.step
            self.steady = steady_program(program)
            cls = get_backend(backend) if isinstance(backend, str) \
                else backend
            self._warm_ex = cls(program, tracer=tracer, device=device,
                                **backend_kwargs)
            self._steady_ex = cls(self.steady, tracer=tracer, device=device,
                                  **backend_kwargs)
            self.session_name = self._warm_ex.name
            layers = program.layers
        self.warm = program
        self._warmed = False
        super().__init__(layers, spec, program.name, tracer, device)

    def bind_layer(self, index, w_lut=None, s_lut=None,
                   w_dsp=None, s_dsp=None) -> None:
        """Bind one layer's weights on both program variants (the
        steady program reuses the resident tiles the warm-up loaded)."""
        for ex in (self._warm_ex, self._steady_ex):
            ex.bind_layer(index, w_lut=w_lut, s_lut=s_lut,
                          w_dsp=w_dsp, s_dsp=s_dsp)

    def step(self, token, pos: int | None = None) -> torch.Tensor:
        from repro_torch.obs import METRICS
        pos = self.pos if pos is None else int(pos)
        phase = "steady" if self._warmed else "warmup"
        with self.tracer.measure(f"exec.{self.session_name}.step",
                                 self.program_name, pos=pos, phase=phase):
            logits = super().step(token, pos)
        self._warmed = True
        METRICS.incr("serve.decode.tokens")
        return logits

    def step_slots(self, tokens, pos) -> torch.Tensor:
        from repro_torch.obs import METRICS
        phase = "steady" if self._warmed else "warmup"
        with self.tracer.measure(f"exec.{self.session_name}.step_slots",
                                 self.program_name, phase=phase):
            logits = super().step_slots(tokens, pos)
        self._warmed = True
        METRICS.incr("serve.decode.tokens", self.spec.batch)
        return logits

    def _run_layer(self, index, x_q):
        ex = self._steady_ex if self._warmed else self._warm_ex
        return ex.run_layer(index, x_q)

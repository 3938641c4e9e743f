"""Program-level optimization passes over compiled :class:`Program`s.

The lowering pass (``lower.py``) emits the canonical Fig.-3 schedule:
double-buffered weight tiles, one Result DMA per output tile, the full
slot-token machinery even where it synchronizes nothing. These passes
rewrite the emitted instruction streams for latency, the way the paper's
instruction-level overlap (Fig. 3) and latency decomposition (Eqs. 6/8)
say the wins should land:

  * :class:`WeightPrefetchPass` — weight-tile prefetch reordering: the
    canonical schedule gates every weight-tile fetch behind a
    double-buffer free-slot token, but the on-chip buffer pools
    (``d_w``/``d_a`` of Table 1) usually hold many more tiles. The pass
    arms the true slot count as initial tokens, so gated fetches issue
    ahead of the canonical double-buffer order and the fetch engine
    streams instead of stalling (L_wait of Eq. 6 drops on DMA-bound
    layers).
  * :class:`SyncElisionPass` — removes sync sends whose tokens are
    provably never consumed (trailing surplus on a channel). For
    single-tile layers this strips the entire free-slot hand-shake; it
    also deletes the sends made dead by the prefetch pass.
  * :class:`DmaFusionPass` — fused result/fetch DMA pairs: adjacent
    Result instructions draining consecutive output tiles merge into a
    single burst, saving one DMA setup per pair. Fusion is profitable
    only when the result engine is the layer bottleneck, so the pass
    keeps a fusion only if the event-driven simulator confirms the
    layer-core makespan does not regress.

Every pass must preserve the ISA contract that the event-driven
scheduler validates:

  * streams stay deadlock-free (every Sync wait remains satisfiable
    from initial tokens plus earlier sends);
  * Execute instructions keep their count and order (the golden
    executor derives tile coordinates from execute ordinals);
  * Fetch/Result instructions keep addressing the layer's DDR segments
    and tiling the partition exactly (fused Results carry their burst
    length in ``onchip_base``; see ``runtime/golden.py``);
  * inter-layer barrier channels (``lut.bar``/``dsp.bar``) are never
    touched — they carry the Eq.-10 synchronous chain.

On-chip buffer addressing is deliberately *out of model*: the 1-bit
``onchip_range`` half-select emitted by the lowering is a ping-pong
write cursor, and slot occupancy is metered by tokens, not by the
encoded buffer address. A prefetch-deepened schedule keeps the cursor
alternating over a pool that holds ``slots`` tiles, and a fused
2-tile burst fills both halves starting at its ``onchip_range``; real
hardware would derive buffer write addresses from the tile index, as
BISMO does, not from this field. The timing model and the golden
executor never read on-chip addresses, so the contract above is the
full contract the passes must keep.

:class:`PassPipeline` re-simulates every layer-core stream after each
pass and raises :class:`PassError` on any deadlock, so a broken rewrite
can never silently ship.
"""
from __future__ import annotations

import copy
import dataclasses
from typing import Protocol, runtime_checkable

from repro_torch.core import isa
from repro_torch.core.scheduler import Op, _dma_cycles, simulate
from repro_torch.compiler.program import (
    CROSS_DEVICE_CHANNELS,
    CoreProgram,
    LayerProgram,
    Program,
)

#: Channels that carry the inter-layer synchronous chain (Eq. 10).
#: No pass may add, remove or reorder syncs on these.
BARRIER_CHANNELS = frozenset({"lut.bar", "dsp.bar"})

#: Channels no pass may touch: barriers plus the cross-device hand-off
#: channels (``*.xdev``), whose matching sync lives in *another*
#: device's program — eliding or reordering one corrupts a hand-off
#: the per-device deadlock check cannot see
#: (``partition.validate_bundle`` re-checks the pairing post-pass).
PROTECTED_CHANNELS = BARRIER_CHANNELS | CROSS_DEVICE_CHANNELS

#: Result-drain channels (execute -> result handshake).
RESULT_CHANNELS = frozenset({"lut.res", "dsp.res"})


class PassError(RuntimeError):
    """A pass produced a program that violates the ISA contract."""


@dataclasses.dataclass(frozen=True)
class PassStats:
    """Per-pass accounting surfaced by the CLI and benchmarks."""
    name: str
    instrs_before: int
    instrs_after: int
    detail: dict

    @property
    def removed(self) -> int:
        return self.instrs_before - self.instrs_after

    def render(self) -> str:
        extra = " ".join(f"{k}={v}" for k, v in self.detail.items())
        return (f"{self.name:<18} {self.instrs_before} -> "
                f"{self.instrs_after} instrs" + (f"  ({extra})" if extra
                                                 else ""))


@runtime_checkable
class Pass(Protocol):
    """One Program rewrite. ``run`` mutates ``prog`` in place and
    returns a detail dict for :class:`PassStats`."""
    name: str

    def run(self, prog: Program) -> dict: ...


# ---------------------------------------------------------------------------
# Pass 1: weight-tile prefetch reordering (buffer-capacity deepening)
# ---------------------------------------------------------------------------


class WeightPrefetchPass:
    """Issue gated tile fetches ahead of the canonical double-buffer
    order by arming the true on-chip slot count as initial tokens.

    The lowering emits slot channels (``lut.wslot`` weight tiles,
    ``dsp.aslot`` activation row tiles) with one initial token — strict
    double buffering. The buffer pools of Table 1 are deeper: the pass
    computes how many tiles actually fit (pool bits // tile bits) and
    raises the initial token count to ``min(slots - 1, #gated fetches)``.
    Waits and sends are untouched, so steady-state metering beyond the
    pool capacity is preserved and the rewrite can only move fetch issue
    times earlier (token monotonicity of the event-driven model) —
    never later.
    """
    name = "weight-prefetch"

    def run(self, prog: Program) -> dict:
        tokens_added = 0
        cores_deepened = 0
        for lp in prog.layers:
            for cp in lp.cores():
                ch, slots = self._capacity(prog, lp, cp)
                if ch is None or slots <= 2:
                    continue
                waits = sum(1 for op in cp.ops()
                            if op.channel == ch
                            and isinstance(op.instr, isa.SyncInstr)
                            and op.instr.is_wait)
                cur = cp.initial_tokens.get(ch, 0)
                new = max(cur, min(slots - 1, waits))
                if new > cur:
                    cp.initial_tokens[ch] = new
                    tokens_added += new - cur
                    cores_deepened += 1
        return {"tokens_added": tokens_added,
                "cores_deepened": cores_deepened}

    @staticmethod
    def _capacity(prog: Program, lp: LayerProgram,
                  cp: CoreProgram) -> tuple[str | None, int]:
        """(slot channel, tile slots the on-chip pool holds) for a core.

        Pool models mirror the residency checks in ``lower.py``: the
        LUT weight pool is N lanes x D_w deep x K bits; the DSP
        activation pool is D_a deep x N_reg_col_a lanes x 4 bits.
        """
        k = lp.dims.k
        if cp.core == isa.CoreSel.LUT:
            cfg = prog.lut_cfg
            tile_bits = cfg.n * k * lp.bits_w_lut
            pool_bits = cfg.n * cfg.d_w * cfg.k
            return ("lut.wslot", pool_bits // tile_bits) if tile_bits \
                else (None, 0)
        cfg = prog.dsp_cfg
        if lp.depthwise:
            tile_bits = cfg.n_reg_row_a * cfg.n_reg_col_w * 4
        else:
            tile_bits = cfg.n_reg_row_a * k * 4
        pool_bits = cfg.d_a * cfg.n_reg_col_a * 4
        return ("dsp.aslot", pool_bits // tile_bits) if tile_bits \
            else (None, 0)


# ---------------------------------------------------------------------------
# Pass 2: sync elision (dead token sends, single-tile layer hand-shakes)
# ---------------------------------------------------------------------------


class SyncElisionPass:
    """Remove Sync sends whose tokens are provably never consumed.

    Per core and channel, waits consume tokens in post order: the
    initial tokens first, then the earliest sends. With ``S`` sends,
    ``W`` waits and ``I`` initial tokens, the trailing
    ``S - max(0, W - I)`` sends post tokens nobody ever pops — pure
    L_sig overhead on the sending engine (Eq. 6). Dropping them cannot
    affect any wait and only moves the sender's later instructions
    earlier.

    Single-tile layers are the flagship case: their entire free-slot
    machinery (``lut.wslot``/``dsp.aslot``) is dead because no gated
    fetch exists. The pass also collects the sends that
    :class:`WeightPrefetchPass` made dead by arming deeper initial
    tokens. Barrier channels are never elided — their sends are
    consumed by the *next* layer's fetch stream.
    """
    name = "sync-elision"

    def run(self, prog: Program) -> dict:
        removed = 0
        single_tile_layers = 0
        for lp in prog.layers:
            layer_removed = 0
            for cp in lp.cores():
                layer_removed += self._elide_core(cp)
            removed += layer_removed
            if layer_removed and lp.n_instructions <= 12:
                single_tile_layers += 1
        return {"syncs_elided": removed,
                "single_tile_layers": single_tile_layers}

    @staticmethod
    def _elide_core(cp: CoreProgram) -> int:
        sends: dict[str, list[tuple[str, int]]] = {}
        waits: dict[str, int] = {}
        for engine, stream in cp.streams.items():
            for idx, op in enumerate(stream):
                if not isinstance(op.instr, isa.SyncInstr):
                    continue
                if op.instr.is_wait:
                    waits[op.channel] = waits.get(op.channel, 0) + 1
                else:
                    sends.setdefault(op.channel, []).append((engine, idx))

        drop: dict[str, set[int]] = {}
        removed = 0
        for ch, slist in sends.items():
            if ch in PROTECTED_CHANNELS:
                continue
            if len({e for e, _ in slist}) != 1:
                # multiple sender engines: cross-engine post order is
                # dynamic, the trailing-surplus argument does not apply
                continue
            consumed = max(0, waits.get(ch, 0)
                           - cp.initial_tokens.get(ch, 0))
            surplus = len(slist) - consumed
            if surplus <= 0:
                continue
            for engine, idx in slist[len(slist) - surplus:]:
                drop.setdefault(engine, set()).add(idx)
                removed += 1
        for engine, idxs in drop.items():
            cp.streams[engine] = [op for i, op
                                  in enumerate(cp.streams[engine])
                                  if i not in idxs]
        return removed


# ---------------------------------------------------------------------------
# Pass 3: fused result/fetch DMA pairs
# ---------------------------------------------------------------------------


class DmaFusionPass:
    """Fuse adjacent DMA pairs moving consecutive tiles into single
    bursts, saving one DMA setup (``dma_setup_cycles``) per pair — on
    both the result and the fetch side of the pipeline.

    Result side: the canonical result stream is
    ``[wait res, RESULT(t)] * n_tiles``; a fused pair becomes
    ``wait res, wait res, RESULT(t, burst=2)``. Both tiles' tokens are
    still consumed before the burst issues, so the execute→result
    ordering contract is intact.

    Fetch side: weight-tile fetch groups
    ``[wait slot?, FETCH(w_j), send wtile]`` for consecutive ``j``
    merge into ``waits..., FETCH(w_j burst=2), send, send``. Both
    wtile tokens post when the burst lands; the slot waits still gate
    the buffer space. Small LM layers are DMA-setup-bound on the fetch
    engine, which makes this the pass that moves their critical path.

    The burst length rides in the otherwise-unused ``onchip_base``
    field of the Fetch/Result word (canonical streams encode 0 there),
    which keeps the asm/binary round-trips bit-exact; the golden
    executor expands ``max(1, onchip_base)`` consecutive tiles per DMA.

    Fusion delays the first tile of each pair, which *hurts* when the
    consumer engine is the bottleneck. The pass therefore simulates
    each layer-core over the (fetch x result x pairing-direction)
    variant cross-product — at most 9 isolated per-layer-core sims,
    usually fewer — and keeps the jointly best one, so a fusion that
    would regress the core makespan is never applied. The joint search
    matters: on DMA-setup-bound LM layers only fetch+result fusion
    *together* beats the baseline. Measured cost: ~3 s for resnet18's
    85k-instruction program, ~9 s for mobilenet_v2 (per-layer streams
    are simulated in isolation, never the whole program).
    """
    name = "dma-fusion"
    max_burst = 2

    def run(self, prog: Program) -> dict:
        result_pairs = fetch_pairs = 0
        cores_reverted = 0
        for lp in prog.layers:
            for cp in lp.cores():
                rp, fp, had_candidates = self._fuse_core(cp, prog.device)
                result_pairs += rp
                fetch_pairs += fp
                if had_candidates and rp == fp == 0:
                    cores_reverted += 1
        return {"result_pairs": result_pairs,
                "fetch_pairs": fetch_pairs,
                "cores_unprofitable": cores_reverted}

    def _fuse_core(self, cp: CoreProgram, dev) -> tuple[int, int, bool]:
        """Pick the jointly best (result x fetch) fusion variant for one
        core by simulated makespan; ties prefer more fused pairs (fewer
        instructions at equal latency). Returns (kept result pairs,
        kept fetch pairs, whether any fusion candidate existed)."""
        f_vars = self._variants(cp.streams["fetch"], self._fuse_fetches, dev)
        r_vars = self._variants(cp.streams["result"], self._fuse_results,
                                dev)
        if len(f_vars) == 1 and len(r_vars) == 1:
            return 0, 0, False
        tokens = cp.sim_tokens()
        best = None          # (total, -pairs, fetch_var, result_var)
        for fs, fn in f_vars:
            for rs, rn in r_vars:
                trial = dict(cp.streams)
                trial["fetch"], trial["result"] = fs, rs
                try:
                    total = simulate(trial, tokens).total_cycles
                except RuntimeError:
                    # a deadlocking candidate is infeasible, not fatal —
                    # the unfused (fn == rn == 0) variant always simulates
                    continue
                key = (total, -(fn + rn))
                if best is None or key < best[0]:
                    best = (key, fs, fn, rs, rn)
        _, fs, fn, rs, rn = best
        cp.streams["fetch"], cp.streams["result"] = fs, rs
        return rn, fn, True

    @classmethod
    def _variants(cls, stream: list[Op], fuser, dev):
        """[(stream, n_pairs)]: unfused plus distinct fwd/tail pairings."""
        out = [(stream, 0)]
        for direction in ("fwd", "tail"):
            fused, n = fuser(stream, dev, direction)
            if n and all(fused != s for s, _ in out):
                out.append((fused, n))
        return out

    # -- result stream ----------------------------------------------------

    @staticmethod
    def _is_result_wait(op: Op) -> bool:
        return (isinstance(op.instr, isa.SyncInstr) and op.instr.is_wait
                and op.channel in RESULT_CHANNELS)

    @classmethod
    def _fusable(cls, a, b) -> int:
        """Burst length if DMAs ``a``/``b`` (same instr kind) fuse, else 0."""
        ca = max(1, a.onchip_base)
        cb = max(1, b.onchip_base)
        nbytes = a.ddr_range + b.ddr_range
        ok = (a.ddr_base == b.ddr_base
              and a.stage_ctrl == b.stage_ctrl
              # never fuse gather (3) or persistent kv/state (4/5) DMAs:
              # their offsets are peer ranks / step positions, not
              # consecutive output tiles
              and a.stage_ctrl < 3
              and b.ddr_offset == a.ddr_offset + ca
              and ca + cb <= cls.max_burst
              # clamped lengths hide the true byte count: don't fuse
              and a.ddr_range < 0xFFFF
              and b.ddr_range < 0xFFFF
              and nbytes <= 0xFFFF)
        return ca + cb if ok else 0

    @classmethod
    def _fuse_results(cls, stream: list[Op], dev,
                      direction: str = "fwd") -> tuple[list[Op], int]:
        def match(i):
            if (i + 1 < len(stream) and cls._is_result_wait(stream[i])
                    and isinstance(stream[i + 1].instr, isa.ResultInstr)):
                return i + 2, (stream[i],), stream[i + 1]
            return None
        return cls._pair_fuse(stream, match, dev, direction)

    @classmethod
    def _fuse_fetches(cls, stream: list[Op], dev,
                      direction: str = "fwd") -> tuple[list[Op], int]:
        def match(i):
            """``[wait slot]? FETCH(stage 0) SEND wtile``"""
            waits = ()
            if (i < len(stream)
                    and isinstance(stream[i].instr, isa.SyncInstr)
                    and stream[i].instr.is_wait
                    and stream[i].channel not in PROTECTED_CHANNELS):
                waits = (stream[i],)
                i += 1
            if (i + 1 < len(stream)
                    and isinstance(stream[i].instr, isa.FetchInstr)
                    and stream[i].instr.stage_ctrl == 0
                    and isinstance(stream[i + 1].instr, isa.SyncInstr)
                    and not stream[i + 1].instr.is_wait):
                return i + 2, waits, stream[i]
            return None
        return cls._pair_fuse(stream, match, dev, direction)

    # -- shared machinery --------------------------------------------------

    @classmethod
    def _pair_fuse(cls, stream: list[Op], match, dev,
                   direction: str) -> tuple[list[Op], int]:
        """Parse ``stream`` into (waits, DMA, sends) groups via ``match``
        and fuse adjacent fusable groups pairwise.

        ``direction`` picks which DMA stays unpaired when a fusable run
        has odd length: ``"fwd"`` pairs head-first (last tile unfused —
        right when the consumer paces the stream and the final token
        must not wait on a longer burst), ``"tail"`` pairs tail-first
        (first tile unfused — right when the engine itself is
        DMA-setup-bound and the critical path ends at the last tile).
        The caller simulates both and keeps the better one.
        """
        # 1. Segment: ('group', waits, dma_op, trailing_ops) | ('op', op)
        items: list[tuple] = []
        i = 0
        while i < len(stream):
            g = match(i)
            if g is not None:
                nxt, waits, dma = g
                items.append(("group", waits, dma,
                              tuple(stream[i + len(waits) + 1:nxt])))
                i = nxt
            else:
                items.append(("op", stream[i]))
                i += 1

        def fuse_pair(first, second):
            _, w_a, dma_a, tail_a = first
            _, w_b, dma_b, tail_b = second
            a, b = dma_a.instr, dma_b.instr
            if {op.channel for op in tail_a} != {op.channel
                                                 for op in tail_b}:
                return None
            burst = cls._fusable(a, b)
            if not burst:
                return None
            nbytes = a.ddr_range + b.ddr_range
            fused = dataclasses.replace(a, onchip_base=burst,
                                        ddr_range=nbytes)
            return ("ops", w_a + w_b
                    + (Op(fused, cycles=_dma_cycles(nbytes, dev)),)
                    + tail_a + tail_b)

        def flat(it):
            return ("ops", it[1] + (it[2],) + it[3]) if it[0] == "group" \
                else ("ops", (it[1],))

        # 2. Pair adjacent groups, head-first or tail-first.
        n_fused = 0
        picked: list[tuple] = []
        if direction == "tail":
            i = len(items) - 1
            while i >= 0:
                merged = (fuse_pair(items[i - 1], items[i])
                          if i >= 1 and items[i][0] == items[i - 1][0]
                          == "group" else None)
                if merged is not None:
                    picked.append(merged)
                    n_fused += 1
                    i -= 2
                else:
                    picked.append(flat(items[i]))
                    i -= 1
            picked.reverse()
        else:
            i = 0
            while i < len(items):
                merged = (fuse_pair(items[i], items[i + 1])
                          if i + 1 < len(items) and items[i][0]
                          == items[i + 1][0] == "group" else None)
                if merged is not None:
                    picked.append(merged)
                    n_fused += 1
                    i += 2
                else:
                    picked.append(flat(items[i]))
                    i += 1

        out: list[Op] = []
        for _, ops in picked:
            out.extend(ops)
        return out, n_fused


# ---------------------------------------------------------------------------
# Pipeline
# ---------------------------------------------------------------------------


class PassPipeline:
    """Run a pass sequence over a Program with post-pass validation.

    After every pass each layer-core stream bundle is re-run through the
    event-driven scheduler (with the layer's isolation tokens): a
    deadlock there means the pass broke the token protocol and raises
    :class:`PassError` naming the pass and layer.
    """

    def __init__(self, passes: list[Pass], validate: bool = True):
        self.passes = list(passes)
        self.validate = validate

    def run(self, prog: Program,
            copy_program: bool = True) -> tuple[Program, list[PassStats]]:
        if copy_program:
            prog = copy.deepcopy(prog)
        stats: list[PassStats] = []
        for p in self.passes:
            before = prog.n_instructions
            detail = p.run(prog)
            stats.append(PassStats(p.name, before, prog.n_instructions,
                                   dict(detail)))
            if self.validate:
                self._check(prog, p.name)
        prog.opt_stats = list(stats)
        return prog, stats

    @staticmethod
    def _check(prog: Program, pass_name: str) -> None:
        from repro_torch.compiler.program import CORE_NAMES
        for lp in prog.layers:
            for cp in lp.cores():
                try:
                    simulate(cp.streams, cp.sim_tokens())
                except RuntimeError as e:
                    raise PassError(
                        f"pass {pass_name!r} broke layer {lp.index} "
                        f"({lp.name}) {CORE_NAMES[cp.core]} streams: {e}"
                    ) from e


#: Pass roster per optimization level. -O0 is the canonical schedule.
O1_PASSES: tuple[type, ...] = (WeightPrefetchPass, SyncElisionPass,
                               DmaFusionPass)
OPT_LEVELS = (0, 1)


def pipeline_for(opt_level: int, validate: bool = True) -> PassPipeline:
    if opt_level not in OPT_LEVELS:
        raise ValueError(f"opt_level must be one of {OPT_LEVELS}, "
                         f"got {opt_level!r}")
    passes = [cls() for cls in O1_PASSES] if opt_level >= 1 else []
    return PassPipeline(passes, validate=validate)


def optimize_program(prog: Program, opt_level: int = 1, *,
                     validate: bool = True,
                     copy_program: bool = True) -> Program:
    """Apply the ``opt_level`` pipeline; per-pass accounting lands on
    ``prog.opt_stats``. ``opt_level=0`` returns the program unchanged."""
    pipeline = pipeline_for(opt_level, validate=validate)
    if not pipeline.passes:
        return prog
    out, _ = pipeline.run(prog, copy_program=copy_program)
    return out

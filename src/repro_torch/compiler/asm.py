"""Assembler / disassembler: Program ↔ text assembly ↔ binary image.

Both directions are bit-exact: ``assemble(disassemble(p)) == p`` and
``from_binary(to_binary(p)) == p``, and re-assembling a disassembled
text (or re-packing a parsed binary) is byte-identical because both
renderers are canonical.

Text syntax (one instruction per line, ``@N`` is the timing closure in
cycles — the scheduler's cycle model evaluated at lowering time):

    .program resnet18
    .device name=XC7Z020 luts=53200 ... freq_mhz=100.0
    .lutcfg m=8 n=16 k=128 ...
    .dspcfg n_reg_row_a=13 ...
    .segment L0.wgt.lut base=0x40 size=1176
    .layer 0 name=conv1 m=12544 k=147 n=64 n_lut=16 bits_w=4 bits_a=4 dw=0
    .core lut tokens=lut.wslot:1 fetched=2352.0 written=50176.0
    .stream fetch
        FETCH  lut buf=0x0 stage=0 half=0 ddr=0x40 off=0 len=1176 @106
        SEND   lut fetch->execute lut.wtile @1
    .stream execute
        WAIT   lut fetch->execute lut.act @1
        EXEC   lut a=0x0 w=0x0 m=8 k=147 n=16 bw=4 ba=4 acc=0 @84
    .stream result
        WAIT   lut execute->result lut.res @1
        RESULT lut buf=0x0 stage=2 half=0 ddr=0x4c0 off=0 len=8 @33

Sync channel names never need to be stated redundantly — they are
recoverable from the 3-bit ``token_flag`` via the per-core tables in
``program.py`` — but the text spells them out for readability.

Fused DMA bursts (``passes.DmaFusionPass``, -O1) carry their tile
count in the ``buf`` (``onchip_base``) operand of Fetch/Result lines —
canonical streams render ``buf=0x0`` there, a fused pair ``buf=0x2`` —
so optimized programs round-trip through both renderers unchanged.

The binary image is ``N3HPROG1`` + a canonical-JSON metadata section
(program/device/core configs, memory map, per-layer metadata) followed
by the packed streams: per (layer, core, engine) a u32 instruction
count then ``count`` records of 16-byte little-endian ISA word + u32
cycles.

Multi-device bundles (``compiler/partition.py``) pack as ``N3HBUND1``:
a canonical-JSON header (name, partition plan, cross-device channel
edge table) followed by one length-prefixed ``N3HPROG1`` section per
device, so a bundle round-trips bit-exactly iff every per-device
program does.
"""
from __future__ import annotations

import dataclasses
import json
import struct

from repro_torch.core import isa
from repro_torch.core.scheduler import (
    DspCoreConfig,
    FPGADevice,
    GemmDims,
    LutCoreConfig,
    Op,
)
from repro_torch.compiler.program import (
    CHANNEL_FLAGS,
    CORE_NAMES,
    ENGINES,
    ConvGeometry,
    CoreProgram,
    ElementwiseOp,
    LayerProgram,
    MemoryMap,
    Program,
    StepSpec,
    channel_of,
)

MAGIC = b"N3HPROG1"
MAGIC_BUNDLE = b"N3HBUND1"

_ENGINE_BY_NAME = {"fetch": isa.Engine.FETCH, "execute": isa.Engine.EXECUTE,
                   "result": isa.Engine.RESULT}
_CORE_BY_NAME = {"lut": isa.CoreSel.LUT, "dsp": isa.CoreSel.DSP}


# ---------------------------------------------------------------------------
# Instruction <-> text line
# ---------------------------------------------------------------------------


def format_instr(op: Op) -> str:
    """One canonical assembly line for a timed instruction."""
    i = op.instr
    cn = CORE_NAMES[i.core]
    if isinstance(i, (isa.FetchInstr, isa.ResultInstr)):
        mn = "FETCH " if isinstance(i, isa.FetchInstr) else "RESULT"
        body = (f"{mn} {cn} buf={i.onchip_base:#x} stage={i.stage_ctrl} "
                f"half={i.onchip_range} ddr={i.ddr_base:#x} "
                f"off={i.ddr_offset} len={i.ddr_range}")
    elif isinstance(i, isa.ExecuteInstr):
        body = (f"EXEC   {cn} a={i.buf_addr_a:#x} w={i.buf_addr_w:#x} "
                f"m={i.tile_m} k={i.tile_k} n={i.tile_n} "
                f"bw={i.bits_w} ba={i.bits_a} acc={i.accumulate}")
    elif isinstance(i, isa.SyncInstr):
        mn = "WAIT  " if i.is_wait else "SEND  "
        src = i.src_engine.name.lower()
        dst = i.dst_engine.name.lower()
        body = f"{mn} {cn} {src}->{dst} {channel_of(i)}"
    else:  # pragma: no cover
        raise TypeError(f"unknown instruction {i!r}")
    return f"{body} @{op.cycles}"


def _kv(tokens: list[str]) -> dict[str, str]:
    out = {}
    for t in tokens:
        k, _, v = t.partition("=")
        out[k] = v
    return out


def parse_instr(line: str) -> Op:
    """Inverse of :func:`format_instr`."""
    body, _, cyc = line.rpartition("@")
    cycles = int(cyc)
    toks = body.split()
    mn = toks[0]
    core = _CORE_BY_NAME[toks[1]]
    if mn in ("FETCH", "RESULT"):
        kv = _kv(toks[2:])
        cls = isa.FetchInstr if mn == "FETCH" else isa.ResultInstr
        return Op(cls(core=core, onchip_base=int(kv["buf"], 0),
                      stage_ctrl=int(kv["stage"]), onchip_range=int(kv["half"]),
                      ddr_base=int(kv["ddr"], 0), ddr_offset=int(kv["off"]),
                      ddr_range=int(kv["len"])), cycles=cycles)
    if mn == "EXEC":
        kv = _kv(toks[2:])
        return Op(isa.ExecuteInstr(
            core=core, buf_addr_a=int(kv["a"], 0), buf_addr_w=int(kv["w"], 0),
            tile_m=int(kv["m"]), tile_k=int(kv["k"]), tile_n=int(kv["n"]),
            bits_w=int(kv["bw"]), bits_a=int(kv["ba"]),
            accumulate=int(kv["acc"])), cycles=cycles)
    if mn in ("SEND", "WAIT"):
        src, _, dst = toks[2].partition("->")
        ch = toks[3]
        flag = CHANNEL_FLAGS[ch]
        is_wait = 1 if mn == "WAIT" else 0
        return Op(isa.SyncInstr(
            core=core, src_engine=_ENGINE_BY_NAME[src],
            dst_engine=_ENGINE_BY_NAME[dst], cur_state=is_wait,
            next_state=min(3, flag), token_flag=flag, is_wait=is_wait),
            cycles=cycles, channel=ch)
    raise ValueError(f"unparseable instruction line: {line!r}")


# ---------------------------------------------------------------------------
# Conv geometry (de)serialization (shared by text and binary forms)
# ---------------------------------------------------------------------------

#: positional field order of the compact geometry record
_GEOM_FIELDS = ("kernel", "stride", "pad", "in_hw", "out_hw", "c_in",
                "c_out", "src_offset", "pool")


def _geom_record(geom: ConvGeometry | None) -> list | None:
    if geom is None:
        return None
    return [getattr(geom, f) for f in _GEOM_FIELDS]


def _geom_from_record(rec) -> ConvGeometry | None:
    if rec is None:
        return None
    vals = dict(zip(_GEOM_FIELDS, rec))
    vals["pool"] = str(vals["pool"])
    return ConvGeometry(**{f: (int(v) if f != "pool" else v)
                           for f, v in vals.items()})


def _fmt_geom(geom: ConvGeometry) -> str:
    """Compact comma-joined positional form for the ``.layer`` line;
    an empty pool renders as ``-``."""
    rec = _geom_record(geom)
    rec[-1] = rec[-1] or "-"
    return ",".join(str(v) for v in rec)


def _parse_geom(text: str) -> ConvGeometry:
    parts = text.split(",")
    if len(parts) != len(_GEOM_FIELDS):
        raise ValueError(f"geometry record needs {len(_GEOM_FIELDS)} "
                         f"fields, got {len(parts)}")
    parts[-1] = "" if parts[-1] == "-" else parts[-1]
    return _geom_from_record(parts)


# ---------------------------------------------------------------------------
# Elementwise tail (de)serialization (shared by text and binary forms)
# ---------------------------------------------------------------------------


def _fmt_ew(ops: tuple) -> str:
    """Compact space-free form for the ``.layer`` line and the binary
    metadata: ``add:2,relu,requant:4`` (the arg is ``src_offset`` for
    ``add`` and ``bits`` for ``requant``)."""
    parts = []
    for op in ops:
        if op.kind == "add":
            parts.append(f"add:{op.src_offset}")
        elif op.kind == "requant":
            parts.append(f"requant:{op.bits}")
        else:
            parts.append(op.kind)
    return ",".join(parts)


def _parse_ew(text: str) -> tuple:
    if not text:
        return ()
    ops = []
    for part in text.split(","):
        kind, _, arg = part.partition(":")
        if kind == "add":
            ops.append(ElementwiseOp("add", src_offset=int(arg)))
        elif kind == "requant":
            ops.append(ElementwiseOp("requant", bits=int(arg)))
        else:
            ops.append(ElementwiseOp(kind))
    return tuple(ops)


# ---------------------------------------------------------------------------
# Config (de)serialization helpers
# ---------------------------------------------------------------------------


def _cfg_fields(cfg) -> dict:
    return {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}


def _fmt_fields(cfg) -> str:
    return " ".join(f"{k}={v!r}" if isinstance(v, float) else f"{k}={v}"
                    for k, v in _cfg_fields(cfg).items())


def _parse_fields(cls, kv: dict[str, str]):
    args = {}
    for f in dataclasses.fields(cls):
        if f.name not in kv:
            continue
        v = kv[f.name]
        args[f.name] = (v if f.type == "str"
                        else float(v) if "." in v or "e" in v.lower()
                        else int(v))
    return cls(**args)


# ---------------------------------------------------------------------------
# Disassembler
# ---------------------------------------------------------------------------


def disassemble(prog: Program) -> str:
    """Canonical text assembly of a compiled program."""
    out = ["; n3h-core unified-ISA program (repro.compiler)",
           f".program {prog.name}",
           f".device {_fmt_fields(prog.device)}",
           f".lutcfg {_fmt_fields(prog.lut_cfg)}",
           f".dspcfg {_fmt_fields(prog.dsp_cfg)}"]
    if prog.step is not None:
        out.append(f".step {_fmt_fields(prog.step)}")
    for seg in prog.memory.segments:
        res = "" if seg.residency == "io" else f" residency={seg.residency}"
        out.append(f".segment {seg.name} base={seg.base:#x} "
                   f"size={seg.size}{res}")
    for lp in prog.layers:
        geom = "" if lp.geometry is None \
            else f" geom={_fmt_geom(lp.geometry)}"
        ew = "" if not lp.elementwise else f" ew={_fmt_ew(lp.elementwise)}"
        out.append(f".layer {lp.index} name={lp.name} m={lp.dims.m} "
                   f"k={lp.dims.k} n={lp.dims.n} n_lut={lp.n_lut} "
                   f"bits_w={lp.bits_w_lut} bits_a={lp.bits_a} "
                   f"dw={int(lp.depthwise)}{geom}{ew}")
        for cp in lp.cores():
            toks = ",".join(f"{ch}:{n}" for ch, n
                            in sorted(cp.initial_tokens.items()))
            out.append(f".core {CORE_NAMES[cp.core]} tokens={toks} "
                       f"fetched={cp.bytes_fetched!r} "
                       f"written={cp.bytes_written!r}")
            for engine in ENGINES:
                out.append(f".stream {engine}")
                for op in cp.streams[engine]:
                    out.append("    " + format_instr(op))
    return "\n".join(out) + "\n"


# ---------------------------------------------------------------------------
# Assembler
# ---------------------------------------------------------------------------


def assemble(text: str) -> Program:
    """Parse canonical text assembly back into a :class:`Program`."""
    name = "unnamed"
    device = lut_cfg = dsp_cfg = step = None
    memory = MemoryMap()
    layers: list[LayerProgram] = []
    cur_core: CoreProgram | None = None
    cur_stream: list[Op] | None = None

    for ln, raw in enumerate(text.splitlines(), 1):
        line = raw.split(";", 1)[0].strip() if raw.lstrip().startswith(";") \
            else raw.strip()
        if not line:
            continue
        try:
            if line.startswith(".program"):
                name = line.split(None, 1)[1]
            elif line.startswith(".device"):
                device = _parse_fields(FPGADevice, _kv(line.split()[1:]))
            elif line.startswith(".lutcfg"):
                lut_cfg = _parse_fields(LutCoreConfig, _kv(line.split()[1:]))
            elif line.startswith(".dspcfg"):
                dsp_cfg = _parse_fields(DspCoreConfig, _kv(line.split()[1:]))
            elif line.startswith(".step"):
                step = _parse_fields(StepSpec, _kv(line.split()[1:]))
            elif line.startswith(".segment"):
                toks = line.split()
                kv = _kv(toks[2:])
                memory.alloc(toks[1], int(kv["size"]),
                             residency=kv.get("residency", "io"))
                if memory[toks[1]].base != int(kv["base"], 0):
                    raise ValueError(
                        f"segment {toks[1]} base {kv['base']} does not match "
                        f"the canonical bump-allocation order")
            elif line.startswith(".layer"):
                toks = line.split()
                kv = _kv(toks[2:])
                layers.append(LayerProgram(
                    index=int(toks[1]), name=kv["name"],
                    dims=GemmDims(int(kv["m"]), int(kv["k"]), int(kv["n"])),
                    n_lut=int(kv["n_lut"]), bits_w_lut=int(kv["bits_w"]),
                    bits_a=int(kv["bits_a"]), depthwise=bool(int(kv["dw"])),
                    lut=None, dsp=None,
                    geometry=_parse_geom(kv["geom"])
                    if "geom" in kv else None,
                    elementwise=_parse_ew(kv.get("ew", ""))))
                cur_core = cur_stream = None
            elif line.startswith(".core"):
                toks = line.split()
                kv = _kv(toks[2:])
                tokens = {}
                if kv.get("tokens"):
                    for part in kv["tokens"].split(","):
                        ch, _, cnt = part.partition(":")
                        tokens[ch] = int(cnt)
                core = _CORE_BY_NAME[toks[1]]
                cur_core = CoreProgram(
                    core=core, streams={e: [] for e in ENGINES},
                    initial_tokens=tokens,
                    bytes_fetched=float(kv["fetched"]),
                    bytes_written=float(kv["written"]))
                setattr(layers[-1], toks[1], cur_core)
                cur_stream = None
            elif line.startswith(".stream"):
                engine = line.split()[1]
                if cur_core is None:
                    raise ValueError(".stream before .core")
                cur_stream = cur_core.streams[engine]
            else:
                if cur_stream is None:
                    raise ValueError("instruction outside a .stream block")
                cur_stream.append(parse_instr(line))
        except (KeyError, IndexError, ValueError) as e:
            raise ValueError(f"assembly parse error at line {ln}: "
                             f"{raw.strip()!r}: {e}") from e

    if device is None or lut_cfg is None or dsp_cfg is None:
        raise ValueError("assembly is missing .device/.lutcfg/.dspcfg")
    return Program(name=name, device=device, lut_cfg=lut_cfg,
                   dsp_cfg=dsp_cfg, layers=layers, memory=memory,
                   step=step)


# ---------------------------------------------------------------------------
# Binary image
# ---------------------------------------------------------------------------


def to_binary(prog: Program) -> bytes:
    """Pack a program into the ``N3HPROG1`` binary image."""
    meta = {
        "program": prog.name,
        "device": _cfg_fields(prog.device),
        "lut_cfg": _cfg_fields(prog.lut_cfg),
        "dsp_cfg": _cfg_fields(prog.dsp_cfg),
        "segments": [[s.name, s.base, s.size, s.residency]
                     for s in prog.memory.segments],
        "layers": [{
            "index": lp.index, "name": lp.name,
            "dims": [lp.dims.m, lp.dims.k, lp.dims.n],
            "n_lut": lp.n_lut, "bits_w": lp.bits_w_lut, "bits_a": lp.bits_a,
            "dw": int(lp.depthwise),
            "geom": _geom_record(lp.geometry),
            "ew": _fmt_ew(lp.elementwise),
            "cores": [{
                "core": CORE_NAMES[cp.core],
                "tokens": dict(sorted(cp.initial_tokens.items())),
                "fetched": cp.bytes_fetched, "written": cp.bytes_written,
            } for cp in lp.cores()],
        } for lp in prog.layers],
    }
    if prog.step is not None:
        meta["step"] = prog.step.to_meta()
    blob = json.dumps(meta, sort_keys=True,
                      separators=(",", ":")).encode("utf-8")
    parts = [MAGIC, struct.pack("<I", len(blob)), blob]
    for lp in prog.layers:
        for cp in lp.cores():
            for engine in ENGINES:
                ops = cp.streams[engine]
                parts.append(struct.pack("<I", len(ops)))
                for op in ops:
                    parts.append(op.instr.encode().to_bytes(16, "little"))
                    parts.append(struct.pack("<I", op.cycles))
    return b"".join(parts)


def from_binary(data: bytes) -> Program:
    """Unpack an ``N3HPROG1`` image back into a :class:`Program`."""
    try:
        return _parse_binary(data)
    except (struct.error, UnicodeDecodeError) as e:
        raise ValueError(f"corrupt N3HPROG1 image: {e}") from e


def _parse_binary(data: bytes) -> Program:
    if data[:8] != MAGIC:
        raise ValueError("not an N3HPROG1 image")
    (meta_len,) = struct.unpack_from("<I", data, 8)
    pos = 12
    meta = json.loads(data[pos:pos + meta_len].decode("utf-8"))
    pos += meta_len

    device = FPGADevice(**meta["device"])
    lut_cfg = LutCoreConfig(**meta["lut_cfg"])
    dsp_cfg = DspCoreConfig(**meta["dsp_cfg"])
    memory = MemoryMap()
    for rec in meta["segments"]:
        # pre-residency images carry 3-element records; default to "io"
        sname, base, size = rec[:3]
        seg = memory.alloc(sname, size,
                           residency=rec[3] if len(rec) > 3 else "io")
        if seg.base != base:
            raise ValueError(f"segment {sname} base mismatch in image")

    layers = []
    for lm in meta["layers"]:
        lp = LayerProgram(
            index=lm["index"], name=lm["name"],
            dims=GemmDims(*lm["dims"]), n_lut=lm["n_lut"],
            bits_w_lut=lm["bits_w"], bits_a=lm["bits_a"],
            depthwise=bool(lm["dw"]), lut=None, dsp=None,
            geometry=_geom_from_record(lm.get("geom")),
            elementwise=_parse_ew(lm.get("ew", "")))
        for cm in lm["cores"]:
            streams = {}
            for engine in ENGINES:
                (count,) = struct.unpack_from("<I", data, pos)
                pos += 4
                ops = []
                for _ in range(count):
                    word = int.from_bytes(data[pos:pos + 16], "little")
                    pos += 16
                    (cycles,) = struct.unpack_from("<I", data, pos)
                    pos += 4
                    instr = isa.decode(word)
                    ch = (channel_of(instr)
                          if isinstance(instr, isa.SyncInstr) else None)
                    ops.append(Op(instr, cycles=cycles, channel=ch))
                streams[engine] = ops
            cp = CoreProgram(core=_CORE_BY_NAME[cm["core"]], streams=streams,
                             initial_tokens={k: int(v) for k, v
                                             in cm["tokens"].items()},
                             bytes_fetched=float(cm["fetched"]),
                             bytes_written=float(cm["written"]))
            setattr(lp, cm["core"], cp)
        layers.append(lp)
    if pos != len(data):
        raise ValueError(f"trailing bytes in image ({len(data) - pos})")
    step = (StepSpec.from_meta(meta["step"])
            if meta.get("step") is not None else None)
    return Program(name=meta["program"], device=device, lut_cfg=lut_cfg,
                   dsp_cfg=dsp_cfg, layers=layers, memory=memory,
                   step=step)


# ---------------------------------------------------------------------------
# Multi-device bundle image (N3HBUND1)
# ---------------------------------------------------------------------------


def _plan_meta(plan) -> dict:
    return {
        "kind": plan.kind,
        "n_devices": plan.n_devices,
        "stages": [list(s) for s in plan.stages]
        if plan.stages is not None else None,
        "shards": [list(s) for s in plan.shards]
        if plan.shards is not None else None,
        "link": {"latency_cycles": plan.link.latency_cycles,
                 "bytes_per_cycle": plan.link.bytes_per_cycle},
    }


def _plan_from_meta(meta: dict):
    from repro_torch.compiler.partition import LinkModel, PartitionPlan
    return PartitionPlan(
        kind=meta["kind"], n_devices=meta["n_devices"],
        stages=tuple(tuple(s) for s in meta["stages"])
        if meta["stages"] is not None else None,
        shards=tuple(tuple(s) for s in meta["shards"])
        if meta["shards"] is not None else None,
        link=LinkModel(latency_cycles=meta["link"]["latency_cycles"],
                       bytes_per_cycle=meta["link"]["bytes_per_cycle"]))


def to_bundle_binary(mdp) -> bytes:
    """Pack a ``MultiDeviceProgram`` into the ``N3HBUND1`` image."""
    meta = {
        "bundle": mdp.name,
        "plan": _plan_meta(mdp.plan),
        "edges": [[e.src_device, e.src_layer, e.dst_device, e.dst_layer,
                   e.src_channel, e.dst_channel, e.nbytes]
                  for e in mdp.edges],
    }
    blob = json.dumps(meta, sort_keys=True,
                      separators=(",", ":")).encode("utf-8")
    parts = [MAGIC_BUNDLE, struct.pack("<I", len(blob)), blob,
             struct.pack("<I", len(mdp.devices))]
    for prog in mdp.devices:
        image = to_binary(prog)
        parts.append(struct.pack("<I", len(image)))
        parts.append(image)
    return b"".join(parts)


def from_bundle_binary(data: bytes):
    """Unpack an ``N3HBUND1`` image back into a ``MultiDeviceProgram``."""
    from repro_torch.compiler.partition import ChannelEdge, MultiDeviceProgram
    try:
        if data[:8] != MAGIC_BUNDLE:
            raise ValueError("not an N3HBUND1 image")
        (meta_len,) = struct.unpack_from("<I", data, 8)
        pos = 12
        meta = json.loads(data[pos:pos + meta_len].decode("utf-8"))
        pos += meta_len
        (n_devices,) = struct.unpack_from("<I", data, pos)
        pos += 4
        devices = []
        for _ in range(n_devices):
            (plen,) = struct.unpack_from("<I", data, pos)
            pos += 4
            devices.append(from_binary(data[pos:pos + plen]))
            pos += plen
        if pos != len(data):
            raise ValueError(
                f"trailing bytes in bundle ({len(data) - pos})")
        edges = [ChannelEdge(src_device=e[0], src_layer=e[1],
                             dst_device=e[2], dst_layer=e[3],
                             src_channel=e[4], dst_channel=e[5],
                             nbytes=e[6]) for e in meta["edges"]]
        return MultiDeviceProgram(name=meta["bundle"],
                                  plan=_plan_from_meta(meta["plan"]),
                                  devices=devices, edges=edges)
    except (struct.error, UnicodeDecodeError, KeyError, IndexError,
            TypeError) as e:
        raise ValueError(f"corrupt N3HBUND1 image: {e!r}") from e


def disassemble_bundle(mdp) -> str:
    """Readable text of a bundle: plan header + per-device assembly.

    Informational (the per-device sections are each valid ``assemble``
    input, but the concatenation is not re-assemblable as a bundle —
    use the ``N3HBUND1`` binary for bit-exact round-trips).
    """
    out = [f"; n3h-core multi-device bundle {mdp.name}",
           f"; plan {mdp.plan.describe()}",
           f"; link latency={mdp.plan.link.latency_cycles} cycles, "
           f"{mdp.plan.link.bytes_per_cycle} B/cycle"]
    for e in mdp.edges:
        out.append(f"; edge dev{e.src_device}.L{e.src_layer} "
                   f"({e.src_channel}) -> dev{e.dst_device}."
                   f"L{e.dst_layer} ({e.dst_channel}) {e.nbytes}B")
    for d, prog in enumerate(mdp.devices):
        out.append(f"; ===== device {d}/{len(mdp.devices)} =====")
        out.append(disassemble(prog).rstrip("\n"))
    return "\n".join(out) + "\n"

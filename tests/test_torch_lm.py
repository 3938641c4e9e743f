"""The port's llama3.2-1b serving path against the JAX package, on the
CPU.

llama3.2-1b's ``smoke`` config (2 layers, d_model 64, GQA 4 over 2
heads, fp32) is built once with the reference's ``lm.init`` and carried
across with ``params_from_jax``, so both packages compute the same
function on the same weights. The prompts are each package's
``SyntheticTokens`` from one seed.

Tolerance for logits: 1e-4 absolute and relative. The two sides run
the same fp32 arithmetic in another order (matmul blocking, the online
softmax's chunks, exp/rsqrt/sin implementations): a few fp32 ulps per
op, through 2 layers, on logits of magnitude ~5 (the largest error
seen was 2e-6). Greedy tokens must be equal.
"""
import dataclasses
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jregistry
from repro.data.synthetic import SyntheticTokens as JSyntheticTokens
from repro.models import layers as jlayers
from repro.models import lm as jlm
from repro.serve import engine as jengine
from repro_torch.configs import registry
from repro_torch.data.synthetic import SyntheticTokens
from repro_torch.kernels.build import LAUNCHES
from repro_torch.launch import serve
from repro_torch.models import layers, lm
from repro_torch.quant import hybrid as quant_hybrid
from repro_torch.serve import engine

ROOT = Path(__file__).resolve().parents[1]
TOL = dict(rtol=1e-4, atol=1e-4)
CPU = torch.device("cpu")
BATCH, PROMPT, NEW = 2, 12, 8


def _smoke(reg):
    arch = reg.get("llama3.2-1b")
    return dataclasses.replace(arch, model=arch.smoke)


@pytest.fixture(scope="module")
def smoke():
    """(JAX arch, port arch, JAX params, port params, prompts numpy)."""
    jarch, tarch = _smoke(jregistry), _smoke(registry)
    jparams = jlm.init(jarch.model, jax.random.key(0))
    tparams = lm.params_from_jax(jax.tree.map(np.asarray, jparams), CPU)
    prompts = np.array(JSyntheticTokens(jarch.model.vocab, BATCH, PROMPT,
                                        seed=0).next_batch()["tokens"])
    return jarch, tarch, jparams, tparams, prompts


def _close(got, want):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_registry_and_config():
    assert registry.list_archs() == ["deepseek-v2-236b", "gemma-7b",
                                     "jamba-v0.1-52b", "llama3.2-1b",
                                     "mamba2-780m", "qwen2-vl-2b",
                                     "qwen3-8b", "qwen3-moe-235b-a22b",
                                     "seamless-m4t-large-v2", "yi-34b"]
    arch = registry.get("llama3.2-1b")
    want = jregistry.get("llama3.2-1b")
    for cfg, ref_cfg in ((arch.model, want.model), (arch.smoke, want.smoke)):
        for f in dataclasses.fields(ref_cfg):
            got, exp = getattr(cfg, f.name), getattr(ref_cfg, f.name)
            if f.name == "param_dtype":
                assert str(got).split(".")[-1] == jnp.dtype(exp).name
            else:
                assert got == exp, f.name
        assert cfg.padded_vocab == ref_cfg.padded_vocab
        assert lm.param_count(cfg) == jlm.param_count(ref_cfg)
    assert arch.model_module() is lm
    with pytest.raises(KeyError, match="unknown arch 'no-such-arch'"):
        registry.get("no-such-arch")


def _jax_fields(fields: dict) -> dict:
    """``fields`` as the reference's config values."""
    conv = {"moe": lambda m: jlayers.MoEConfig(**dataclasses.asdict(m)),
            "mla": lambda m: jlm.MLAConfig(**dataclasses.asdict(m))}
    return {k: conv.get(k, lambda v: v)(v) for k, v in fields.items()}


@pytest.mark.parametrize("fields", [
    {"moe": layers.MoEConfig(n_experts=4, top_k=2, d_ff=32),
     "n_dense_prefix": 1},
    {"mla": lm.MLAConfig(kv_lora=16, q_lora=24, qk_nope_dim=8,
                         qk_rope_dim=8, v_dim=8)},
    {"mrope_sections": (2, 3, 3)},
    {"n_dense_prefix": 1}], ids=["moe-dense-prefix", "mla", "mrope",
                                 "dense-prefix"])
def test_other_configs_name_their_slice(fields):
    """The config features that used to name their later slice (MLA,
    M-RoPE, a dense prefix, deepseek-v2's MoE behind one) are served
    now: the parameter tree, its count and the forward's logits equal
    the reference's on its weights."""
    cfg = dataclasses.replace(registry.get("llama3.2-1b").smoke, **fields)
    jcfg = dataclasses.replace(jregistry.get("llama3.2-1b").smoke,
                               **_jax_fields(fields))
    jp = jlm.init(jcfg, jax.random.key(0))
    tp = lm.params_from_jax(jax.tree.map(np.asarray, jp), CPU)
    assert layers.tree_map(lambda s: s.shape, lm.param_specs(cfg)) == \
        jax.tree.map(lambda a: tuple(a.shape), jp)
    assert lm.param_count(cfg) == jlm.param_count(jcfg)
    toks = np.random.default_rng(0).integers(0, 512, (2, 10)).astype(
        np.int32)
    want, _ = jlm.forward(jp, jnp.asarray(toks), jcfg)
    got, _ = lm.forward(tp, torch.from_numpy(toks), cfg)
    _close(got, want)


def test_synthetic_tokens_are_the_references():
    for vocab, b, s, seed in ((512, 2, 12, 0), (128256, 8, 64, 0),
                              (1000, 3, 5, 7)):
        mine = SyntheticTokens(vocab, b, s, seed=seed)
        theirs = JSyntheticTokens(vocab, b, s, seed=seed)
        for _ in range(2):
            got = mine.next_batch()["tokens"]
            assert got.dtype == torch.int32
            np.testing.assert_array_equal(
                got.numpy(), np.asarray(theirs.next_batch()["tokens"]))


def test_init_follows_the_param_laws():
    cfg = registry.get("llama3.2-1b").smoke
    params = lm.init(cfg, torch.Generator().manual_seed(0))
    want = jlm.init(_smoke(jregistry).model, jax.random.key(0))
    shapes = jax.tree.map(lambda a: tuple(a.shape), want)
    assert layers.tree_map(lambda t: tuple(t.shape), params) == shapes
    assert torch.equal(params["ln_f"], torch.ones(cfg.d_model))
    # embed ~ N(0, 1); wq ~ N(0, 1/d_model)
    assert abs(float(params["embed"].std()) - 1.0) < 0.05
    wq = params["layers"]["attn"]["wq"]
    assert abs(float(wq.std()) * cfg.d_model ** 0.5 - 1.0) < 0.05
    again = lm.init(cfg, torch.Generator().manual_seed(0))
    assert torch.equal(again["embed"], params["embed"])


def test_params_from_jax_keeps_bf16_bits():
    tree = {"w": jax.random.normal(jax.random.key(1), (3, 5),
                                   jnp.bfloat16)}
    got = lm.params_from_jax(jax.tree.map(np.asarray, tree), CPU)["w"]
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(
        got.view(torch.int16).numpy(),
        np.asarray(tree["w"]).view(np.int16))
    wide = lm.params_from_jax(tree, CPU, torch.float32)["w"]
    np.testing.assert_array_equal(wide.numpy(),
                                  np.asarray(tree["w"], np.float32))


def test_rmsnorm_and_rope_match_reference():
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 7, 4, 16)).astype(np.float32)
    scale = rng.uniform(0.5, 1.5, 16).astype(np.float32)
    pos = np.broadcast_to(np.arange(7, dtype=np.int32) + 100, (2, 7))
    _close(layers.rmsnorm(torch.from_numpy(x), torch.from_numpy(scale)),
           jlayers.rmsnorm(jnp.asarray(x), jnp.asarray(scale)))
    _close(layers.apply_rope(torch.from_numpy(x),
                             torch.from_numpy(pos.copy()), 500000.0),
           jlayers.apply_rope(jnp.asarray(x), jnp.asarray(pos), 500000.0))


def test_forward_matches_reference(smoke):
    jarch, tarch, jparams, tparams, prompts = smoke
    want, _ = jlm.forward(jparams, jnp.asarray(prompts), jarch.model)
    got, _ = lm.forward(tparams, torch.from_numpy(prompts), tarch.model)
    _close(got, want)


def test_prefill_and_decode_logits_match_reference(smoke):
    """Prefill logits, then each decode step's logits over the reference's
    greedy tokens, fed to both packages."""
    jarch, tarch, jparams, tparams, prompts = smoke
    max_seq = PROMPT + NEW
    jcache = jengine.make_cache(jarch, BATCH, max_seq, jnp.float32)
    tcache = engine.make_cache(tarch, BATCH, max_seq, torch.float32, CPU)
    jlogits, jcache = jax.jit(jengine.make_prefill_fn(jarch))(
        jparams, {"tokens": jnp.asarray(prompts)}, jcache)
    before = dict(LAUNCHES)
    tlogits, tcache = engine.make_prefill_fn(tarch)(
        tparams, {"tokens": torch.from_numpy(prompts)}, tcache)
    assert dict(LAUNCHES) == before       # plain versions on the CPU
    _close(tlogits, jlogits)
    _close(tcache["layers"]["k"], jcache["layers"]["k"])
    _close(tcache["layers"]["v"], jcache["layers"]["v"])

    jdecode = jax.jit(jengine.make_decode_fn(jarch))
    tdecode = engine.make_decode_fn(tarch)
    tok = np.array(jnp.argmax(jlogits[:, -1], axis=-1))[:, None]
    for pos in range(PROMPT, PROMPT + NEW - 1):
        jlogits, jcache = jdecode(jparams, jnp.asarray(tok, jnp.int32),
                                  jcache, jnp.int32(pos))
        tlogits, tcache = tdecode(tparams, torch.from_numpy(tok).int(),
                                  tcache, pos)
        _close(tlogits, jlogits)
        tok = np.array(jnp.argmax(jlogits, axis=-1))[:, None]
    _close(tcache["layers"]["k"], jcache["layers"]["k"])


def test_greedy_tokens_equal_reference(smoke):
    jarch, tarch, jparams, tparams, prompts = smoke
    want = jengine.greedy_generate(jarch, jparams, jnp.asarray(prompts), NEW)
    got = engine.greedy_generate(tarch, tparams, torch.from_numpy(prompts),
                                 NEW)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # the plain-version run of prefill attention gives the same tokens
    again = engine.greedy_generate(tarch, tparams, torch.from_numpy(prompts),
                                   NEW, attn_mode="ref")
    assert torch.equal(again, got)


def _quantized(arch, mod):
    return dataclasses.replace(arch, model=dataclasses.replace(
        arch.model, hetero_quant=mod.HeteroQuantConfig(
            w_bits_lut=4, a_bits=8, ratio=0.5)))


def test_quantized_prefill_and_decode_match_reference(smoke):
    """``--quantize``'s hybrid fake-quant projections (the reference's
    ``HeteroQuantConfig`` forward, w 4-bit LUT / int4 DSP columns at
    ratio 0.5, a 8-bit) on the same params: prefill logits, then each
    decode step over the reference's greedy tokens, within ``TOL`` (the
    same fp32 arithmetic in another order; the quantizers' roundings
    agree, so no code moves)."""
    jarch, tarch, jparams, tparams, prompts = smoke
    jarch, tarch = _quantized(jarch, jlm), _quantized(tarch, lm)
    max_seq = PROMPT + NEW
    jcache = jengine.make_cache(jarch, BATCH, max_seq, jnp.float32)
    tcache = engine.make_cache(tarch, BATCH, max_seq, torch.float32, CPU)
    jlogits, jcache = jax.jit(jengine.make_prefill_fn(jarch))(
        jparams, {"tokens": jnp.asarray(prompts)}, jcache)
    tlogits, tcache = engine.make_prefill_fn(tarch)(
        tparams, {"tokens": torch.from_numpy(prompts)}, tcache)
    _close(tlogits, jlogits)
    plain, _ = engine.make_prefill_fn(_smoke(registry))(
        tparams, {"tokens": torch.from_numpy(prompts)},
        engine.make_cache(tarch, BATCH, max_seq, torch.float32, CPU))
    assert not torch.allclose(plain, tlogits, **TOL)   # quantization acts

    jdecode = jax.jit(jengine.make_decode_fn(jarch))
    tdecode = engine.make_decode_fn(tarch)
    tok = np.array(jnp.argmax(jlogits[:, -1], axis=-1))[:, None]
    for pos in range(PROMPT, PROMPT + 3):
        jlogits, jcache = jdecode(jparams, jnp.asarray(tok, jnp.int32),
                                  jcache, jnp.int32(pos))
        tlogits, tcache = tdecode(tparams, torch.from_numpy(tok).int(),
                                  tcache, pos)
        _close(tlogits, jlogits)
        tok = np.array(jnp.argmax(jlogits, axis=-1))[:, None]


def test_quantized_projection_casts_like_reference():
    """``_proj``'s fake-quant on bf16 operands: the weight is rounded
    back to bf16 before the product, as the reference's
    ``q.astype(w.dtype)`` does; the result equals the reference's
    bits."""
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 3, 32)).astype(np.float32)
    w = (rng.standard_normal((32, 24)) / 6).astype(np.float32)
    cfg = dataclasses.replace(registry.get("llama3.2-1b").smoke,
                              hetero_quant=lm.HeteroQuantConfig(
                                  w_bits_lut=3, a_bits=8, ratio=0.25))
    jcfg = dataclasses.replace(jregistry.get("llama3.2-1b").smoke,
                               hetero_quant=jlm.HeteroQuantConfig(
                                   w_bits_lut=3, a_bits=8, ratio=0.25))
    xb, wb = torch.from_numpy(x).bfloat16(), torch.from_numpy(w).bfloat16()
    got = lm._proj(xb, wb, cfg)
    want = jlm._proj(jnp.asarray(x, jnp.bfloat16),
                     jnp.asarray(w, jnp.bfloat16), jcfg)
    assert got.dtype == torch.bfloat16
    # bitwise at this size: the same roundings, a 32-term bf16 product
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want, np.float32))
    assert lm.HeteroQuantConfig().layer_cfg() == \
        quant_hybrid.LayerQuantConfig(w_bits_lut=4, a_bits=4, ratio=0.5)


@pytest.mark.parametrize("kw,msg", [
    ({"ratio": 1.5}, "ratio must be in [0,1], got 1.5"),
    ({"w_bits_lut": 9}, "w_bits_lut out of range: 9"),
    ({"a_bits": 0}, "a_bits out of range: 0")])
def test_layer_quant_config_range_errors(kw, msg):
    from repro.quant.hybrid import LayerQuantConfig as JLayerQuantConfig
    for cls in (quant_hybrid.LayerQuantConfig, JLayerQuantConfig):
        with pytest.raises(ValueError) as info:
            cls(**kw)
        assert str(info.value) == msg
    assert quant_hybrid.LayerQuantConfig(ratio=0.3).n_lut_filters(10) == 3


def test_serve_quantize_refuses_other_families():
    with pytest.raises(SystemExit) as exc:
        serve.main(["--arch", "mamba2-780m", "--quantize"])
    assert exc.value.code == ("--quantize drives the lm family here; "
                              "other families quantize via HeteroLinear "
                              "directly")


def _encdec_arch():
    """The reference's encoder-decoder (seamless-m4t-large-v2) at its
    smoke config."""
    arch = registry.get("seamless-m4t-large-v2")
    return dataclasses.replace(arch, model=arch.smoke)


def _unserved_arch():
    """An arch of a model module with no serving path (the CNNs'), on
    llama3.2-1b's smoke config."""
    return dataclasses.replace(registry.get("llama3.2-1b"), module="cnn",
                               arch_id="cnn-test")


def test_other_families_raise():
    """Every model module of the registry is served now, the
    encoder-decoder included (its engine factories build and run on the
    CPU); a module with no serving path still raises, naming the ones
    the port serves."""
    arch = _encdec_arch()
    assert arch.module in engine.SERVED == ("lm", "ssm", "hybrid", "encdec")
    cache = engine.make_cache(arch, 1, 8, torch.float32, device=CPU)
    params = arch.model_module().init(arch.model, torch.Generator())
    batch = {"tokens": torch.zeros((1, 8), dtype=torch.int32),
             "frames": torch.zeros((1, 8, arch.model.d_model))}
    logits, cache = engine.make_prefill_fn(arch)(params, batch, cache)
    step, _ = engine.make_decode_fn(arch)(
        params, torch.zeros((1, 1), dtype=torch.int32), cache, 7)
    assert logits.shape == (1, 8, 512) and step.shape == (1, 512)
    other = _unserved_arch()
    for factory in (engine.make_prefill_fn, engine.make_decode_fn):
        with pytest.raises(NotImplementedError, match="no serving path"):
            factory(other)
    with pytest.raises(NotImplementedError, match="the port serves modules"):
        engine.make_cache(other, 1, 8, device=CPU)


def test_serve_launcher_on_cpu(capsys, tmp_path):
    metrics = tmp_path / "m.json"
    out = serve.main(["--arch", "llama3.2-1b", "--smoke", "--device", "cpu",
                      "--batch", "2", "--prompt-len", "8", "--new-tokens",
                      "4", "--metrics", str(metrics)])
    text = capsys.readouterr().out
    for line in ("prefill:", "decode:", "sample tokens:"):
        assert line in text
    assert out["tokens"].shape == (2, 4)
    assert "serve.request.prefill_ms" in metrics.read_text()
    # the same prompts as the reference's launcher draws
    np.testing.assert_array_equal(
        out["prompts"].numpy(),
        np.asarray(JSyntheticTokens(512, 2, 8, seed=0).next_batch()["tokens"]))


class ReachedTheCard(Exception):
    """Raised where a launcher makes its first tensor on the card."""


def serve_on_a_fake_card(monkeypatch, argv):
    """``serve.main(argv)`` with CUDA reported available, stopped where it
    makes its generator on the device (this CPU build has no CUDA
    tensors); returns the flash head sizes and dtype it routed, and the
    device it reached."""
    from repro_torch.kernels import flash_attention as fa
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    routed = []

    def route(*a, **k):
        routed.append((*a, k.get("needs_grad")))
        return fa.kernel_route(*a, **k)

    def generator(device=None):
        raise ReachedTheCard(str(device))
    monkeypatch.setattr(serve, "kernel_route", route)
    monkeypatch.setattr(torch, "Generator", generator)
    with pytest.raises(ReachedTheCard) as exc:
        serve.main(argv)
    return routed, str(exc.value)


@pytest.mark.parametrize("device", [[], ["--device", "cuda"],
                                    ["--device", "cuda:0"]],
                         ids=["default", "cuda", "cuda0"])
def test_serve_smoke_takes_the_card(monkeypatch, device):
    """The smoke config (head_dim 16, fp32) is served on a CUDA device:
    the launcher routes its attention to the fp32 flash kernel (no
    gradient) and goes on to build the model on the card."""
    cfg = registry.get("llama3.2-1b").smoke
    assert cfg.head_dim == 16 and cfg.param_dtype == torch.float32
    routed, reached = serve_on_a_fake_card(
        monkeypatch, ["--arch", "llama3.2-1b", "--smoke", *device])
    assert routed == [(16, 16, torch.float32, False)]
    assert reached == (device[1] if device else "cuda")


def test_serve_refuses_a_pair_without_a_kernel(monkeypatch):
    """A config whose head size no kernel takes (fp32 at 96) raises in
    the launcher before anything is built."""
    base = registry.get("llama3.2-1b")
    odd = dataclasses.replace(base, smoke=dataclasses.replace(
        base.smoke, head_dim=96))
    monkeypatch.setattr(serve.registry, "get", lambda _: odd)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    before = dict(LAUNCHES)
    with pytest.raises(NotImplementedError, match=r"\(96, 96\)"):
        serve.main(["--arch", "llama3.2-1b", "--smoke"])
    assert dict(LAUNCHES) == before


@pytest.mark.parametrize("arch", ["encdec-test"])
def test_serve_refuses_archs_without_a_forward(capsys, monkeypatch, arch):
    """The encoder-decoder, refused before it was ported, is served: the
    launcher runs it on the CPU. An arch of a module with no serving
    path (the CNNs') makes the launcher exit 2 naming the modules it
    serves, before anything is built, card or no card."""
    out = serve.main(["--arch", "seamless-m4t-large-v2", "--smoke",
                      "--device", "cpu", "--batch", "2", "--prompt-len",
                      "6", "--new-tokens", "3"])
    assert out["tokens"].shape == (2, 3)
    assert "# arch=seamless-smoke layers=2+2" in capsys.readouterr().out
    other = dataclasses.replace(_unserved_arch(), arch_id=arch)
    monkeypatch.setattr(registry, "get", lambda name: other)
    with pytest.raises(SystemExit) as exc:
        serve.main(["--arch", arch])
    assert exc.value.code == 2
    err = capsys.readouterr().err
    assert err.startswith(f"error: {arch} is a 'cnn' arch")
    assert str(engine.SERVED) in err


@pytest.mark.parametrize("arch", ["mamba2-780m", "qwen3-8b", "gemma-7b",
                                  "yi-34b"])
def test_serve_launcher_serves_the_other_archs_on_cpu(capsys, arch):
    """The archs whose refusals this slice removed: their smoke configs
    served end to end on the plain versions (prompts the reference's)."""
    out = serve.main(["--arch", arch, "--smoke", "--device", "cpu",
                      "--batch", "2", "--prompt-len", "8", "--new-tokens",
                      "3"])
    text = capsys.readouterr().out
    assert f"# arch={arch}-smoke layers=2" in text and "sample tokens:" in text
    assert out["tokens"].shape == (2, 3)
    np.testing.assert_array_equal(
        out["prompts"].numpy(),
        np.asarray(JSyntheticTokens(512, 2, 8, seed=0).next_batch()["tokens"]))


def test_serve_layers_cuts_the_depth(capsys):
    out = serve.main(["--arch", "yi-34b", "--smoke", "--device", "cpu",
                      "--layers", "1", "--batch", "1", "--prompt-len", "4",
                      "--new-tokens", "2"])
    assert "# arch=yi-34b-smoke layers=1" in capsys.readouterr().out
    assert out["tokens"].shape == (1, 2)
    with pytest.raises(SystemExit, match=r"--layers must be in \[1, 2\]"):
        serve.main(["--arch", "yi-34b", "--smoke", "--device", "cpu",
                    "--layers", "3"])


def test_serve_imports_pull_in_no_jax():
    code = ("import sys, repro_torch.launch.serve, "
            "repro_torch.configs.registry as r; "
            "r.get('llama3.2-1b').model_module(); "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro')]; "
            "assert not bad, bad")
    env = {"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin"}
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr

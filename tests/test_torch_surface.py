"""The port's public surface against the JAX package's.

The JAX side is read from its source with ``ast`` (nothing of it is
imported); the port's side is imported and read with ``inspect``, so a class
attribute such as ``ChatterboxVC.collect = staticmethod(collect)`` counts.
For every public module-level function, public class and public method
(and ``__init__``) of ``chatterbox_tpu/**/*.py`` the port must have the
counterpart at the same module path, taking the JAX positional parameters
in their order with the JAX defaults; a further parameter of the port's must
be keyword-only. Parameters whose names start with ``_`` are private and
not compared. A JAX default is evaluated in the port module's namespace,
with ``jnp.<dtype>`` read as ``torch.<dtype>``.

Each deliberate difference is an entry of ``EXCEPTIONS``, keyed by the JAX
name relative to the package (``models.t3.t3.t3_generate``) or by one of its
parameters (``models.t3.t3.t3_generate(rng)``), with the port's counterpart
(a name relative to ``chatterbox_tpu_torch``, a keyword-only parameter of
the port's function, or None) and the reason. An entry that no longer names
something of the JAX package, or no longer names a difference, fails.
"""

import ast
import importlib
import importlib.util
import inspect
import pathlib
from typing import NamedTuple

import numpy as np
import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
JAX_PKG, PORT_PKG = "chatterbox_tpu", "chatterbox_tpu_torch"

_TPU_TILING = "TPU tiling of the Pallas kernel (ROADMAP \"No TPU speed targets\")"
_RNG = "the port draws from a torch.Generator or injected draws (ROADMAP C3, C11)"
_SCAN = "the XLA decode loop's scan and jit wrappers; the port calls t3_generate_start/_resume"
_INIT = "the port's seeded inits live in chatterbox_tpu_torch/weights.py (ROADMAP C12)"

# JAX name or JAX name(parameter) -> (the port's counterpart or None, reason)
EXCEPTIONS = {
    "runtime.enable_compilation_cache": (None, "XLA's persistent compilation cache"),
    "runtime.precision.cast_floating_jit": (
        "runtime.precision.cast_floating", "a jax.jit of cast_floating; eager PyTorch casts"),
    "models.watermark.SpreadSpectrumWatermarker.apply_in_graph": (
        "models.watermark.SpreadSpectrumWatermarker.apply",
        "a jax.jit surface; the port watermarks on the device through apply (ROADMAP C10)"),
    "models.t3.llama.llama_decode_step_unrolled": ("models.t3.llama.llama_decode_step", _SCAN),
    "models.t3.t3.t3_generate(decode_impl)": (None, _SCAN),
    "models.t3.t3.t3_generate(scan_unroll)": (None, _SCAN),
    "models.t3.t3.t3_generate(use_pallas)": (None, "the port's entry points always launch "
                                             "the kernels on the card (plain on the CPU)"),
    "models.t3.t3.t3_generate_resume(decode_impl)": (None, _SCAN),
    "models.t3.t3.t3_generate_resume(scan_unroll)": (None, _SCAN),
    "models.t3.t3.t3_generate_resume(use_pallas)": (None, "the port's entry points always "
                                                    "launch the kernels on the card"),
    "models.t3.t3.t3_generate_resume(alignment)": (
        None, "the port's carry holds the watchdog's state (t3_generate starts it); "
              "resume runs it when the carry has one"),
    "pipeline.streaming.t3_chunked_start_fn": ("models.t3.t3.t3_generate_start", _SCAN),
    "pipeline.streaming.t3_chunked_step_fn": ("models.t3.t3.t3_generate_resume", _SCAN),
    "ops.flash_attention.flash_self_attention_packed(interpret)": (None, _TPU_TILING),
    "ops.flash_attention.flash_self_attention_packed(q_block)": (None, _TPU_TILING),
    "ops.flash_attention.flash_self_attention(interpret)": (None, _TPU_TILING),
    "ops.flash_attention.flash_self_attention(q_block)": (None, _TPU_TILING),
    "ops.flash_attention.flash_self_attention(heads_per_cell)": (None, _TPU_TILING),
    "ops.flash_attention.flash_relpos_attention(interpret)": (None, _TPU_TILING),
    "ops.flash_attention.flash_relpos_attention(heads_per_cell)": (None, _TPU_TILING),
    "ops.flash_decode.flash_decode_layer_attention(interpret)": (None, _TPU_TILING),
    "ops.flash_decode.flash_decode_layer_attention(s_block)": (None, _TPU_TILING),
    "ops.flash_decode.flash_decode_layer_attention(rows_per_cell)": (None, _TPU_TILING),
    "ops.flash_decode.flash_decode_layer_attention(ds_layout)": (
        None, "the TPU's (D, S) cache layout; the port's cache is (S, D)"),
    "ops.flash_decode.flash_decode_layer_attention(tail)": (
        "ops.flash_decode.flash_decode_layer_attention_int8", "the int8 cache's kernel (K1c+d)"),
    "ops.flash_decode.flash_decode_layer_attention(merge_base)": (
        "ops.flash_decode.flash_decode_layer_attention_int8", "the int8 cache's kernel (K1c+d)"),
    "ops.flash_decode.flash_decode_layer_attention(scales)": (
        "ops.flash_decode.flash_decode_layer_attention_int8", "the int8 cache's kernel (K1c+d)"),
    "ops.flash_decode.flash_decode_layer_attention(return_stats)": (
        "ops.flash_decode.flash_decode_layer_attention_stats", "the stats kernel (K1b)"),
    "ops.flash_decode.flash_cache_merge_ds": (
        "ops.flash_decode.kv_cache_quantize_write",
        "the (D, S) layout's column merge; the port writes its caches with kv_cache_append "
        "and kv_cache_quantize_write"),
    "models.t3.llama.llama_prefill(ds_layout)": (
        None, "the TPU's (D, S) cache layout; the port's cache is (S, D)"),
    "models.t3.llama.llama_decode_step": (
        "models.t3.llama.llama_decode_step",
        "TPU cache-layout and scan parameters; the port's step takes the write slot, the "
        "row prefixes and the gap of its (S, D) cache"),
    "models.t3.t3.t3_generate(rng)": ("generator", _RNG),
    "models.t3.t3.t3_generate_start(rng)": ("generator", _RNG),
    "models.s3gen.hifigan.hift_generate(rng)": ("generator", _RNG),
    "models.s3gen.s3gen.s3gen_wav(rng)": ("generator", _RNG),
    "train.losses.cfm_loss(rng)": ("generator", _RNG),
    "models.t3.alignment.init_align_state(max_new)": (
        None, "kept by the JAX package only for API compatibility; the state does not "
              "depend on it"),
    "checkpoint.safetensors_io.load_safetensors(to_float32_bf16)": (
        None, "the port returns BF16 payloads as bit patterns with their names, so BF16 "
              "leaves load bit for bit (ROADMAP C10); load_params(device_put=False) widens"),
    "serve.server.build_fastapi_app": (
        None, "no fastapi on either machine (ROADMAP A22); the stdlib server serves"),
    "models.s3gen.conformer.rel_pos_attention(pos_emb)": (
        None, "the dense path builds the table of its own length (espnet_rel_pe); the K4 "
              "path needs none"),
    "models.s3gen.conformer.conformer_layer(pos_emb)": (
        None, "the attention builds its positional table itself (rel_pos_attention)"),
    "models.s3gen.conformer.init_upsample_conformer": ("weights.init_flow", _INIT),
    "models.s3gen.flow.init_flow": ("weights.init_flow", _INIT),
    "models.s3gen.hifigan.init_hift": ("weights.init_hift", _INIT),
    "models.s3gen.s3gen.init_s3gen": ("pipeline.tts.random_s3gen", _INIT),
    "models.s3gen.unet.init_unet": ("weights.init_flow", _INIT),
    "models.s3gen.xvector.init_campplus": ("weights.init_campplus", _INIT),
    "models.s3tokenizer.init_s3tokenizer": ("weights.init_s3tokenizer", _INIT),
    "models.t3.cond_enc.init_cond_enc": ("weights.init_t3", _INIT),
    "models.t3.llama.init_llama": ("weights.init_t3", _INIT),
    "models.t3.t3.init_t3": ("weights.init_t3", _INIT),
    "models.voice_encoder.init_voice_encoder": ("weights.init_voice_encoder", _INIT),
}


class _Def(NamedTuple):
    qual: str  # "fn", "Cls" or "Cls.method"
    node: ast.AST
    kind: str  # function, class, method, staticmethod, classmethod, property


def _modules():
    """The JAX package's modules, relative to it ('' is the package)."""
    out = []
    for f in sorted((ROOT / JAX_PKG).rglob("*.py")):
        parts = f.relative_to(ROOT / JAX_PKG).with_suffix("").parts
        out.append(".".join(parts[:-1] if parts[-1] == "__init__" else parts))
    return out


def _full(pkg, rel):
    return f"{pkg}.{rel}" if rel else pkg


def _source(module):
    path = ROOT / JAX_PKG / pathlib.Path(*module.split(".")) if module else ROOT / JAX_PKG
    return (path / "__init__.py") if path.is_dir() else path.with_suffix(".py")


def _decorators(node):
    return {ast.unparse(d).split("(")[0] for d in node.decorator_list}


def _jax_defs(module):
    tree = ast.parse(_source(module).read_text())
    defs = []
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)) and node.name[0] != "_":
            defs.append(_Def(node.name, node, "function"))
        elif isinstance(node, ast.ClassDef) and node.name[0] != "_":
            defs.append(_Def(node.name, node, "class"))
            for sub in node.body:
                if not isinstance(sub, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    continue
                if sub.name[0] == "_" and sub.name != "__init__":
                    continue
                deco = _decorators(sub)
                kind = next((k for k in ("staticmethod", "classmethod", "property") if k in deco),
                            "property" if any(d.endswith(".setter") for d in deco) else "method")
                defs.append(_Def(f"{node.name}.{sub.name}", sub, kind))
    return defs


def _jax_params(d: _Def):
    """(positional [(name, default expr or None)], keyword-only [...], *args,
    **kwargs) of a JAX def, without self/cls."""
    a = d.node.args
    pos = a.posonlyargs + a.args
    defaults = [None] * (len(pos) - len(a.defaults)) + list(a.defaults)
    pairs = [(p.arg, dflt) for p, dflt in zip(pos, defaults)]
    if d.kind in ("method", "classmethod"):
        pairs = pairs[1:]
    kwonly = [(p.arg, dflt) for p, dflt in zip(a.kwonlyargs, a.kw_defaults)]
    return pairs, kwonly, a.vararg is not None, a.kwarg is not None


_MISSING = object()


def _resolve(rel):
    """A name relative to the port's package -> the object, or _MISSING.
    Class attributes are read statically (staticmethod, classmethod and
    property objects as such)."""
    parts = rel.split(".")
    for i in range(len(parts), -1, -1):
        name = _full(PORT_PKG, ".".join(parts[:i]))
        try:
            if importlib.util.find_spec(name) is None:
                continue
        except ModuleNotFoundError:
            continue
        obj = importlib.import_module(name)
        for part in parts[i:]:
            try:
                obj = (inspect.getattr_static(obj, part) if inspect.isclass(obj)
                       else getattr(obj, part))
            except AttributeError:
                return _MISSING
        return obj
    return _MISSING


def _port_params(obj, in_class: bool):
    """The port object's parameters without self/cls, or None for a
    property."""
    if isinstance(obj, property):
        return None
    drop = 0
    if isinstance(obj, staticmethod):
        obj = obj.__func__
    elif isinstance(obj, classmethod):
        obj, drop = obj.__func__, 1
    elif in_class and inspect.isfunction(obj):
        drop = 1
    return list(inspect.signature(obj).parameters.values())[drop:]


class _JnpAsTorch:
    def __getattr__(self, name):
        return getattr(torch, name)


def _same_default(expr, value, module):
    ns = dict(vars(importlib.import_module(_full(PORT_PKG, module))))
    ns.update(jnp=_JnpAsTorch(), np=np)
    try:
        want = eval(ast.unparse(expr), ns)  # noqa: S307 -- the JAX package's own source
    except Exception as e:  # noqa: BLE001 -- reported as a difference
        return f"cannot evaluate {ast.unparse(expr)!r} in the port's module ({e!r})"
    try:
        same = bool(want == value)
    except Exception:  # noqa: BLE001
        same = repr(want) == repr(value)
    return None if same else f"{want!r} != {value!r}"


def _differences(module, d: _Def, obj, excepted=()):
    """What keeps the port's ``obj`` from taking ``d``'s parameters, leaving
    out the JAX parameters named in ``excepted``."""
    if d.kind == "class":
        return [] if inspect.isclass(obj) else ["not a class"]
    if d.kind == "property":
        return [] if isinstance(obj, property) else ["not a property"]
    params = _port_params(obj, in_class="." in d.qual)
    if params is None:
        return ["a property in the port"]
    pos, kwonly, varargs, varkw = _jax_params(d)
    pos = [(n, e) for n, e in pos if n[0] != "_" and n not in excepted]
    kinds = inspect.Parameter
    port_pos = [p for p in params if p.kind in (kinds.POSITIONAL_ONLY,
                                                kinds.POSITIONAL_OR_KEYWORD)]
    port_pos = [p for p in port_pos if p.name[0] != "_"]
    out = []
    jax_names, port_names = [n for n, _ in pos], [p.name for p in port_pos]
    if port_names[: len(jax_names)] != jax_names:
        out.append(f"positional parameters {port_names}, the JAX package's {jax_names}")
    elif len(port_names) > len(jax_names):
        out.append(f"positional {port_names[len(jax_names):]} past the JAX package's: "
                   f"make them keyword-only")
    by_name = {p.name: p for p in params}
    for name, expr in pos + [(n, e) for n, e in kwonly if n[0] != "_" and n not in excepted]:
        p = by_name.get(name)
        if p is None:
            out.append(f"no parameter {name!r}")
            continue
        if expr is None:
            if p.default is not inspect.Parameter.empty:
                out.append(f"{name!r} has a default, the JAX package's has none")
            continue
        if p.default is inspect.Parameter.empty:
            out.append(f"{name!r} has no default, the JAX package's is {ast.unparse(expr)}")
            continue
        why = _same_default(expr, p.default, module)
        if why:
            out.append(f"default of {name!r}: {why}")
    if varargs and not any(p.kind == kinds.VAR_POSITIONAL for p in params):
        out.append("no *args")
    if varkw and not any(p.kind == kinds.VAR_KEYWORD for p in params):
        out.append("no **kwargs")
    return out


def _key(module, qual):
    return f"{module}.{qual}" if module else qual


def _excepted_params(module, qual):
    head = _key(module, qual) + "("
    return {k[len(head):-1] for k in EXCEPTIONS if k.startswith(head)}


def _surface_problems(module):
    """Every difference of the port's module from the JAX module that no
    entry of EXCEPTIONS names."""
    spec = importlib.util.find_spec(_full(PORT_PKG, module))
    if spec is None:
        return [f"no module {_full(PORT_PKG, module)}"]
    problems = []
    for d in _jax_defs(module):
        key = _key(module, d.qual)
        if key in EXCEPTIONS:
            continue
        obj = _resolve(key)
        if obj is _MISSING:
            problems.append(f"{key}: missing")
            continue
        problems += [f"{key}: {why}" for why in
                     _differences(module, d, obj, _excepted_params(module, d.qual))]
    return problems


@pytest.mark.parametrize("module", _modules(), ids=lambda m: m or "(package)")
def test_port_module_has_the_jax_surface(module):
    problems = _surface_problems(module)
    assert not problems, "\n".join(problems)


def _split(key):
    """'a.b.fn(param)' -> ('a.b', 'fn', 'param'); the module is the longest
    prefix that is a JAX module."""
    name, param = (key[:-1].split("(") + [None])[:2] if key.endswith(")") else (key, None)
    modules = set(_modules())
    parts = name.split(".")
    for i in range(len(parts) - 1, -1, -1):
        if ".".join(parts[:i]) in modules:
            return ".".join(parts[:i]), ".".join(parts[i:]), param
    raise AssertionError(f"{key}: no module of the JAX package")


def _stale(key):
    """Why ``key``'s entry no longer names a live difference, or None."""
    counterpart, reason = EXCEPTIONS[key]
    if not reason or "\n" in reason:
        return "the reason must be one line"
    module, qual, param = _split(key)
    d = next((d for d in _jax_defs(module) if d.qual == qual), None)
    if d is None:
        return f"the JAX package has no {qual} in {module or 'the package'}"
    mirror = _resolve(key.split("(")[0])
    if param is not None:
        pos, kwonly, _, _ = _jax_params(d)
        if param not in [n for n, _ in pos + kwonly]:
            return f"the JAX package's {qual} has no parameter {param!r}"
        if mirror is _MISSING:
            return f"the port has no {qual} to leave {param!r} out of"
        port = {p.name: p for p in _port_params(mirror, "." in qual) or []}
        if param in port and port[param].kind != inspect.Parameter.KEYWORD_ONLY:
            return f"the port's {qual} takes {param!r} positionally now"
        if counterpart and "." not in counterpart:
            if port.get(counterpart, None) is None or \
                    port[counterpart].kind != inspect.Parameter.KEYWORD_ONLY:
                return f"the port's {qual} has no keyword-only {counterpart!r}"
        elif counterpart and _resolve(counterpart) is _MISSING:
            return f"the port has no {counterpart}"
        return None
    if counterpart == key:
        if mirror is _MISSING:
            return f"the port has no {key}"
        if not _differences(module, d, mirror, _excepted_params(module, qual)):
            return f"the port's {key} takes the JAX parameters now"
        return None
    if mirror is not _MISSING:
        return f"the port has {key} now"
    if counterpart is not None and _resolve(counterpart) is _MISSING:
        return f"the port has no {counterpart}"
    return None


@pytest.mark.parametrize("key", sorted(EXCEPTIONS))
def test_exception_names_a_live_difference(key):
    why = _stale(key)
    assert why is None, f"EXCEPTIONS[{key!r}] is stale: {why}"


def test_stale_entries_are_caught(monkeypatch):
    """The staleness check itself: entries naming what the JAX package does
    not have, or a difference the port no longer has, are reported."""
    fake = {
        "models.t3.t3.no_such_function": (None, "x"),
        "models.t3.t3.t3_generate(no_such_param)": (None, "x"),
        "models.t3.t3.t3_loss": (None, "x"),  # the port has it
        "models.t3.t3.t3_generate(max_new_tokens)": (None, "x"),  # positional in the port
        "models.t3.t3.init_t3": ("weights.no_such_init", "x"),
        "models.voice_encoder.ve_embed_from_mels": ("models.voice_encoder.ve_embed_from_mels",
                                                    "x"),  # no difference left
    }
    for key, entry in fake.items():
        monkeypatch.setitem(EXCEPTIONS, key, entry)
    for key in fake:
        assert _stale(key) is not None, key


def test_gate_flags_signature_drift():
    """The comparison itself, on a JAX def parsed from text against port
    functions that drift from it."""
    node = ast.parse("def f(a, b=1, c=None, *, d=2):\n    pass\n").body[0]
    d = _Def("f", node, "function")

    def same(a, b=1, c=None, *, d=2, e=3):
        pass

    def extra_positional(a, b=1, c=None, e=3, *, d=2):
        pass

    def other_default(a, b=2, c=None, *, d=2):
        pass

    def reordered(a, c=None, b=1, *, d=2):
        pass

    def no_kwonly(a, b=1, c=None):
        pass

    def without_b(a, c=None, *, d=2):
        pass

    assert _differences("core.layers", d, same) == []
    for fn in (extra_positional, other_default, reordered, no_kwonly, without_b):
        assert _differences("core.layers", d, fn), fn.__name__
    assert _differences("core.layers", d, without_b, excepted={"b"}) == []

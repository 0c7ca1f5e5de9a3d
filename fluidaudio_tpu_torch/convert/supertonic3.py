"""Supertonic-3 ONNX release -> flax trees by GRAPH TOPOLOGY, not names.

Upstream (supertone-inc/supertonic) publishes ONLY four ONNX graphs —
text_encoder.onnx, duration_predictor.onnx, vector_estimator.onnx,
vocoder.onnx (~398 MB total; reference republishes them as CoreML,
`Supertonic3Constants.swift:9-13`). There is no public torch source and ONNX
exports carry opaque tensor names (`onnx::MatMul_2031`-style), so a
name-pattern mapping cannot be authored blind. Conversion instead keys on
the only stable coordinates an export has: the ORDER in which weights are
consumed along the (topologically sorted) node list, each consumer's
op_type, and the initializer's shape.

Per stage, `*_slots(cfg)` declares that expected weight-consumption stream
for `models/supertonic3.py`'s graph — one `WeightSlot` per initializer, in
execution order, with the ONNX-side shape and the ONNX->flax layout adapter.
`match_stage` zips an `OnnxGraph`'s weight-event stream against the slots
(repeated uses of one initializer dedupe to its first consumption) and
raises `ConversionError` with a positional diff on ANY mismatch — partial
conversions are loud, never silent.

`synthesize_stage_onnx` writes a graph from the same slot table with opaque
names; `tests/test_supertonic3_convert.py` pins that the matcher recovers
the exact ground-truth tree from it and that the tree loads + runs in the
flax stages.

The published scalar contract (latent 24x6, text T 128, style 50x256/8x16,
44.1 kHz) is pinned in models/supertonic3.py / tests/test_tts_backends.py.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from pathlib import Path

import numpy as np

from fluidaudio_tpu_torch.convert.onnx_reader import OnnxGraph, read_onnx, read_onnx_graph
from fluidaudio_tpu_torch.convert.onnx_writer import encode_node, write_onnx
from fluidaudio_tpu_torch.models.supertonic3 import (
    DP_STYLE_DIM,
    DP_STYLE_TOKENS,
    LATENT_CH,
    TEXT_EMB_DIM,
    TTL_STYLE_DIM,
    Supertonic3Config,
)

STAGES = ("text_encoder", "duration_predictor", "vector_estimator", "vocoder")


class ConversionError(ValueError):
    pass


def inventory(model_dir: str | Path) -> dict[str, dict]:
    """Decode each stage's ONNX graph: initializer shapes + op histogram."""
    model_dir = Path(model_dir)
    out: dict[str, dict] = {}
    for stage in STAGES:
        path = model_dir / f"{stage}.onnx"
        if not path.exists():
            out[stage] = {"present": False}
            continue
        weights, ops = read_onnx(path)
        out[stage] = {
            "present": True,
            "n_initializers": len(weights),
            "total_params": int(sum(int(np.prod(w.shape)) for w in weights.values())),
            "ops": ops,
            "shapes": {k: tuple(v.shape) for k, v in weights.items()},
        }
    return out


# --------------------------------------------------------------------------
# Slot tables: the expected weight-consumption stream per stage
# --------------------------------------------------------------------------


@dataclass(frozen=True)
class WeightSlot:
    path: tuple[str, ...]  # flax param path under "params"
    ops: tuple[str, ...]  # acceptable consumer op_types
    shape: tuple[int, ...]  # ONNX-side shape
    adapter: str = "raw"  # raw | qkv_kernel | qkv_bias | out_kernel | conv | convtr
    heads: int = 0  # for the reshape adapters
    group: int = -1  # consecutive slots with the same group share ONE node
    attrs: dict = field(default_factory=dict)  # node attrs for the synthesizer


def _ln(path_prefix: tuple[str, ...], d: int, g: int) -> list[WeightSlot]:
    return [
        WeightSlot(path_prefix + ("scale",), ("LayerNormalization",), (d,), group=g),
        WeightSlot(path_prefix + ("bias",), ("LayerNormalization",), (d,), group=g),
    ]


def _dense(path_prefix: tuple[str, ...], i: int, o: int) -> list[WeightSlot]:
    return [
        WeightSlot(path_prefix + ("kernel",), ("MatMul", "Gemm"), (i, o)),
        WeightSlot(path_prefix + ("bias",), ("Add", "Gemm"), (o,)),
    ]


def _mha(prefix: tuple[str, ...], d: int, heads: int) -> list[WeightSlot]:
    """flax {Self,MultiHeadDotProduct}Attention: q/k/v/out, head-split params."""
    out = []
    for part in ("query", "key", "value"):
        out.append(WeightSlot(prefix + (part, "kernel"), ("MatMul", "Gemm"), (d, d),
                              adapter="qkv_kernel", heads=heads))
        out.append(WeightSlot(prefix + (part, "bias"), ("Add", "Gemm"), (d,),
                              adapter="qkv_bias", heads=heads))
    out.append(WeightSlot(prefix + ("out", "kernel"), ("MatMul", "Gemm"), (d, d),
                          adapter="out_kernel", heads=heads))
    out.append(WeightSlot(prefix + ("out", "bias"), ("Add", "Gemm"), (d,)))
    return out


def _tf_block(prefix: tuple[str, ...], d: int, heads: int, g: int) -> list[WeightSlot]:
    """models/supertonic3.TransformerBlock: ln1, attn, ln2, ff1, ff2."""
    return (
        _ln(prefix + ("ln1",), d, g)
        + _mha(prefix + ("attn",), d, heads)
        + _ln(prefix + ("ln2",), d, g + 1)
        + _dense(prefix + ("ff1",), d, 4 * d)
        + _dense(prefix + ("ff2",), 4 * d, d)
    )


def text_encoder_slots(cfg: Supertonic3Config) -> list[WeightSlot]:
    d, h = cfg.d_model, cfg.n_heads
    g = 0
    slots = [
        WeightSlot(("embed", "embedding"), ("Gather",), (cfg.vocab_size, d)),
        WeightSlot(("pos",), ("Add",), (cfg.text_t, d)),
    ]
    for i in range(cfg.n_text_layers):
        slots += _tf_block((f"block{i}",), d, h, g)
        g += 2
        s = (f"style{i}",)
        slots += _dense(s + ("style_proj",), TTL_STYLE_DIM, d)
        slots += _ln(s + ("ln",), d, g)
        g += 1
        slots += _mha(s + ("attn",), d, h)
    slots += _ln(("out_ln",), d, g)
    slots += _dense(("out_proj",), d, TEXT_EMB_DIM)
    return slots


def duration_predictor_slots(cfg: Supertonic3Config) -> list[WeightSlot]:
    d, h = cfg.d_model, cfg.n_heads
    slots = [
        WeightSlot(("embed", "embedding"), ("Gather",), (cfg.vocab_size, d)),
    ]
    slots += _dense(("style_proj",), DP_STYLE_TOKENS * DP_STYLE_DIM, d)
    for i in range(2):
        slots += [
            WeightSlot((f"conv{i}", "kernel"), ("Conv",), (d, d, 3),
                       adapter="conv", group=10 + i,
                       attrs={"pads": [1, 1], "kernel_shape": [3]}),
            WeightSlot((f"conv{i}", "bias"), ("Conv",), (d,), group=10 + i),
        ]
    slots += _tf_block(("block",), d, h, 0)
    slots += _dense(("out",), d, 1)
    return slots


def vector_estimator_slots(cfg: Supertonic3Config) -> list[WeightSlot]:
    w, h = cfg.est_width, cfg.n_heads
    slots = _dense(("in_proj",), LATENT_CH, w)
    slots.append(WeightSlot(("pos",), ("Add",), (cfg.max_latent, w)))
    slots += _dense(("t1",), w, w)
    slots += _dense(("t2",), w, w)
    slots += _dense(("ctx_proj",), TEXT_EMB_DIM, w)
    slots += _dense(("sty_proj",), TTL_STYLE_DIM, w)
    g = 0
    for i in range(cfg.n_est_layers):
        b = (f"block{i}",)
        slots += _dense(b + ("mod",), w, 6 * w)
        # ln1/ln2 are parameterless (adaLN-zero); ln_c carries scale/bias
        slots += _mha(b + ("attn",), w, h)
        slots += _ln(b + ("ln_c",), w, g)
        g += 1
        slots += _mha(b + ("cross",), w, h)
        slots += _dense(b + ("ff1",), w, 4 * w)
        slots += _dense(b + ("ff2",), 4 * w, w)
    slots += _ln(("out_ln",), w, g)
    slots += _dense(("out_proj",), w, LATENT_CH)
    return slots


def vocoder_slots(cfg: Supertonic3Config) -> list[WeightSlot]:
    from fluidaudio_tpu_torch.models.supertonic3 import LATENT_DIM

    ch = cfg.voc_width
    slots = [
        WeightSlot(("pre", "kernel"), ("Conv",), (ch, LATENT_DIM, 7),
                   adapter="conv", group=20, attrs={"pads": [3, 3]}),
        WeightSlot(("pre", "bias"), ("Conv",), (ch,), group=20),
    ]
    g = 30
    for i, r in enumerate(cfg.voc_rates):
        c_out = max(ch // 2, 8)
        k = 2 * r
        slots += [
            WeightSlot((f"up_kernel_{i}",), ("ConvTranspose",), (ch, c_out, k),
                       adapter="convtr", group=g,
                       attrs={"strides": [r], "pads": [(k - r) // 2, (k - r) // 2]}),
            WeightSlot((f"up_bias_{i}",), ("ConvTranspose",), (c_out,), group=g),
        ]
        g += 1
        for j, dil in enumerate((1, 3)):
            slots.append(WeightSlot((f"res{i}", f"alpha{j}"), ("Mul",),
                                    (1, 1, c_out)))
            slots += [
                WeightSlot((f"res{i}", f"conv{j}", "kernel"), ("Conv",),
                           (c_out, c_out, 3), adapter="conv", group=g,
                           attrs={"dilations": [dil],
                                  "pads": [(3 * dil - dil) // 2] * 2}),
                WeightSlot((f"res{i}", f"conv{j}", "bias"), ("Conv",),
                           (c_out,), group=g),
            ]
            g += 1
        ch = c_out
    slots += [
        WeightSlot(("post", "kernel"), ("Conv",), (1, ch, 7),
                   adapter="conv", group=g, attrs={"pads": [3, 3]}),
        WeightSlot(("post", "bias"), ("Conv",), (1,), group=g),
    ]
    return slots


SLOT_BUILDERS = {
    "text_encoder": text_encoder_slots,
    "duration_predictor": duration_predictor_slots,
    "vector_estimator": vector_estimator_slots,
    "vocoder": vocoder_slots,
}


# --------------------------------------------------------------------------
# Matching
# --------------------------------------------------------------------------


def _adapt(slot: WeightSlot, arr: np.ndarray) -> np.ndarray:
    arr = np.asarray(arr, np.float32)
    if slot.adapter == "raw":
        return arr
    if slot.adapter == "qkv_kernel":
        d_in, d_out = arr.shape
        return arr.reshape(d_in, slot.heads, d_out // slot.heads)
    if slot.adapter == "qkv_bias":
        (d,) = arr.shape
        return arr.reshape(slot.heads, d // slot.heads)
    if slot.adapter == "out_kernel":
        d_in, d_out = arr.shape
        return arr.reshape(slot.heads, d_in // slot.heads, d_out)
    if slot.adapter == "conv":  # [O, I, K] -> [K, I, O]
        return np.ascontiguousarray(np.transpose(arr, (2, 1, 0)))
    if slot.adapter == "convtr":  # [I, O, K] -> [K, I, O]
        return np.ascontiguousarray(np.transpose(arr, (2, 0, 1)))
    raise ConversionError(f"unknown adapter {slot.adapter!r}")


def _set_path(tree: dict, path: tuple[str, ...], value: np.ndarray) -> None:
    node = tree
    for key in path[:-1]:
        node = node.setdefault(key, {})
    node[path[-1]] = value


def match_stage(graph: OnnxGraph, slots: list[WeightSlot], stage: str) -> dict:
    """Zip the graph's weight-event stream against the slot table.

    Events are (node, input_position, initializer, shape) in graph order;
    an initializer consumed by several nodes (snake alphas, tied weights)
    counts once, at its first consumption."""
    seen: set[str] = set()
    events = []
    for node, pos, name, shape in graph.weight_events():
        if name in seen:
            continue
        seen.add(name)
        events.append((node, name, tuple(int(d) for d in shape)))

    errors: list[str] = []
    if len(events) != len(slots):
        errors.append(
            f"{stage}: {len(events)} weight events vs {len(slots)} expected slots"
        )
    params: dict = {}
    for idx, (slot, ev) in enumerate(zip(slots, events)):
        node, name, shape = ev
        if node.op_type not in slot.ops:
            errors.append(
                f"{stage}[{idx}] {'/'.join(slot.path)}: consumer {node.op_type} "
                f"not in {slot.ops}"
            )
            continue
        if shape != slot.shape:
            errors.append(
                f"{stage}[{idx}] {'/'.join(slot.path)}: shape {shape} != "
                f"expected {slot.shape} (op {node.op_type}, tensor {name!r})"
            )
            continue
        _set_path(params, slot.path, _adapt(slot, graph.weights[name]))
    if errors:
        preview = "; ".join(errors[:12])
        raise ConversionError(
            f"supertonic3 {stage}: topology mismatch vs models/supertonic3.py "
            f"({len(errors)} issues): {preview}"
            + ("; …" if len(errors) > 12 else "")
            + " — run convert.supertonic3.inventory() and align the slot table."
        )
    return {"params": params}


def convert_supertonic3(
    model_dir: str | Path, cfg: Supertonic3Config | None = None
) -> dict[str, dict]:
    """Four ONNX graphs -> {stage: flax tree} by topology matching."""
    cfg = cfg or Supertonic3Config()
    model_dir = Path(model_dir)
    missing = [s for s in STAGES if not (model_dir / f"{s}.onnx").exists()]
    if missing:
        raise ConversionError(f"missing ONNX files for stages: {missing}")
    out: dict[str, dict] = {}
    for stage in STAGES:
        graph = read_onnx_graph(model_dir / f"{stage}.onnx")
        out[stage] = match_stage(graph, SLOT_BUILDERS[stage](cfg), stage)
    return out


# --------------------------------------------------------------------------
# Synthetic fixture (shares the slot tables; opaque names)
# --------------------------------------------------------------------------


def synthesize_stage_onnx(
    path: str | Path, slots: list[WeightSlot], rng: np.random.RandomState
) -> dict:
    """Write an ONNX graph realizing the slot stream with OPAQUE tensor names
    (`t_<n>`); returns the ground-truth flax tree for equivalence testing."""
    inits: dict[str, np.ndarray] = {}
    nodes: list[bytes] = []
    truth: dict = {}
    prev = "input_0"
    i = 0
    n = 0
    while i < len(slots):
        group = [slots[i]]
        if slots[i].group >= 0:
            while i + len(group) < len(slots) and slots[i + len(group)].group == slots[i].group:
                group.append(slots[i + len(group)])
        names = []
        for slot in group:
            name = f"t_{n}"
            n += 1
            inits[name] = (rng.randn(*slot.shape) * 0.05).astype(np.float32)
            _set_path(truth, slot.path, _adapt(slot, inits[name]))
            names.append(name)
        op = group[0].ops[0]
        out_name = f"v_{n}"
        # Gather consumes (data, indices); everything else is (x, w...)
        node_inputs = [names[0], prev] if op == "Gather" else [prev, *names]
        nodes.append(encode_node(op, node_inputs, [out_name],
                                 attrs=group[0].attrs or None))
        prev = out_name
        i += len(group)
    write_onnx(path, nodes, inits)
    return {"params": truth}


def synthesize_supertonic3_fixture(
    model_dir: str | Path, cfg: Supertonic3Config, seed: int = 0
) -> dict[str, dict]:
    """Write all four stage graphs; returns {stage: ground-truth tree}."""
    model_dir = Path(model_dir)
    model_dir.mkdir(parents=True, exist_ok=True)
    rng = np.random.RandomState(seed)
    return {
        stage: synthesize_stage_onnx(
            model_dir / f"{stage}.onnx", SLOT_BUILDERS[stage](cfg), rng
        )
        for stage in STAGES
    }

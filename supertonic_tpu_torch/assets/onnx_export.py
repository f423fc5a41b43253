"""Export the native models to reference-format ONNX bundles (a copy of
``supertonic_tpu.assets.onnx_export``; numpy only, byte-equal output).

The reference's distributable artifact IS a directory of four ONNX graphs
behind the §2.2 I/O contract (SURVEY.md; reference py/helper.py:289-306).
This module produces that artifact from our native param pytree: each
``export_*`` mirrors the corresponding ``models/*.apply`` op-for-op with
shape-polymorphic graphs (dynamic B/L/T via Shape/Range chains), so the
exported bundle runs under ONNX Runtime, our own executor
(assets/onnx_exec.py), or any §2.2-compatible port.

Uses:
  * deployment parity — a native-trained/converted model can be shipped in
    the exact format every reference port consumes;
  * the auto-mapper round-trip proof (assets/automap.py): params -> export
    -> structural re-import with NO name information -> bit-equal params;
  * deep executor stress on realistic transformer graphs.

Initializer names are the flattened param-tree paths ('/'-joined) by
default; ``anonymize=True`` renames them to opaque torch-style names so
structure-only tooling can be tested honestly.
"""

from __future__ import annotations

import math
import os

import numpy as np

from ..config import TTSConfig
from . import onnx_reader as R

F32, I64 = np.float32, np.int64

MODEL_FILES = ("duration_predictor", "text_encoder",
               "vector_estimator", "vocoder")


class G:
    """Tiny ONNX graph tape over the wire-level writer."""

    def __init__(self, name: str):
        self.name = name
        self.nodes: list[bytes] = []
        self.inits: list[tuple[str, np.ndarray]] = []
        self._n = 0

    def _fresh(self, hint: str) -> str:
        self._n += 1
        return f"{hint}_{self._n}"

    def c(self, arr, name: str | None = None) -> str:
        """Register a constant/weight initializer; returns its name."""
        arr = np.asarray(arr)
        name = name or self._fresh("const")
        self.inits.append((name, arr))
        return name

    def n(self, op: str, inputs: list[str], attrs: dict | None = None,
          n_out: int = 1, hint: str | None = None):
        outs = [self._fresh(hint or op.lower()) for _ in range(n_out)]
        self.nodes.append(R.encode_node(op, inputs, outs, attrs=attrs,
                                        name=self._fresh(f"n_{op}")))
        return outs[0] if n_out == 1 else tuple(outs)

    # ---- convenience ----------------------------------------------------
    def add(self, a, b):
        return self.n("Add", [a, b])

    def sub(self, a, b):
        return self.n("Sub", [a, b])

    def mul(self, a, b):
        return self.n("Mul", [a, b])

    def div(self, a, b):
        return self.n("Div", [a, b])

    def cf(self, v) -> str:
        """Scalar f32 constant."""
        return self.c(np.asarray(v, F32))

    def transpose(self, x, perm):
        return self.n("Transpose", [x], {"perm": list(perm)})

    def reshape(self, x, shape_name):
        return self.n("Reshape", [x, shape_name])

    def shape_dim(self, x, axis: int) -> str:
        """Shape(x)[axis] as an int64 [1] tensor."""
        sh = self.n("Shape", [x])
        return self.n("Gather", [sh, self.c(np.asarray([axis], I64))],
                      {"axis": 0})

    def range_f32(self, upto_i64: str) -> str:
        """[0, 1, ..., n-1] as f32 [n]; ``upto_i64`` is an int64 [1]."""
        n0 = self.n("Squeeze", [upto_i64, self.c(np.asarray([0], I64))])
        r = self.n("Range", [self.c(np.asarray(0, I64)), n0,
                             self.c(np.asarray(1, I64))])
        return self.n("Cast", [r], {"to": 1})

    def unsq(self, x, axes):
        return self.n("Unsqueeze", [x, self.c(np.asarray(axes, I64))])

    def squeeze(self, x, axes):
        return self.n("Squeeze", [x, self.c(np.asarray(axes, I64))])

    def concat(self, xs, axis):
        return self.n("Concat", list(xs), {"axis": axis})

    def sigmoid(self, x):
        return self.n("Sigmoid", [x])

    def silu(self, x):
        return self.mul(x, self.sigmoid(x))

    def reduce_sum(self, x, axes, keepdims):
        return self.n("ReduceSum", [x, self.c(np.asarray(axes, I64))],
                      {"keepdims": int(keepdims)})

    # ---- layers.py mirrors ----------------------------------------------
    def linear(self, p: dict, x: str, prefix: str) -> str:
        w = self.c(np.asarray(p["w"], F32), f"{prefix}/w")
        b = self.c(np.asarray(p["b"], F32), f"{prefix}/b")
        return self.add(self.n("MatMul", [x, w]), b)

    def layer_norm(self, p: dict, x: str, prefix: str) -> str:
        g = self.c(np.asarray(p["g"], F32), f"{prefix}/g")
        b = self.c(np.asarray(p["b"], F32), f"{prefix}/b")
        return self.n("LayerNormalization", [x, g, b],
                      {"axis": -1, "epsilon": 1e-5})

    def embedding(self, p: dict, ids: str, prefix: str) -> str:
        t = self.c(np.asarray(p["table"], F32), f"{prefix}/table")
        return self.n("Gather", [t, ids], {"axis": 0})

    def conv1d(self, p: dict, x_btc: str, prefix: str, *,
               dilation: int = 1) -> str:
        """layers.conv1d ('SAME' for odd kernels) on [B,T,C] tensors.
        Weight [k, cin, cout] -> ONNX [cout, cin, k]."""
        w = np.ascontiguousarray(
            np.transpose(np.asarray(p["w"], F32), (2, 1, 0)))
        k = w.shape[2]
        total = dilation * (k - 1)
        wn = self.c(w, f"{prefix}/w")
        bn = self.c(np.asarray(p["b"], F32), f"{prefix}/b")
        xc = self.transpose(x_btc, (0, 2, 1))
        y = self.n("Conv", [xc, wn, bn],
                   {"dilations": [dilation], "kernel_shape": [k],
                    "pads": [total // 2, total - total // 2],
                    "strides": [1]})
        return self.transpose(y, (0, 2, 1))

    def rope_angles(self, pos_bt: str, head_dim: int, theta: float):
        """(cos, sin) each [B, T, 1, half] ready to broadcast over heads."""
        half = head_dim // 2
        freqs = np.exp(-math.log(theta)
                       * np.arange(half, dtype=F32) / half).astype(F32)
        ang = self.mul(self.unsq(pos_bt, [2]), self.c(freqs))  # [B,T,half]
        cos = self.unsq(self.n("Cos", [ang]), [2])
        sin = self.unsq(self.n("Sin", [ang]), [2])
        return cos, sin

    def apply_rope(self, x_bthd: str, cos: str, sin: str, head_dim: int):
        x1, x2 = self.n("Split", [x_bthd], {"axis": -1,
                                            "num_outputs": 2}, n_out=2)
        out1 = self.sub(self.mul(x1, cos), self.mul(x2, sin))
        out2 = self.add(self.mul(x1, sin), self.mul(x2, cos))
        return self.concat([out1, out2], -1)

    def split_heads(self, x_btd: str, n_heads: int, head_dim: int) -> str:
        return self.reshape(
            x_btd, self.c(np.asarray([0, 0, n_heads, head_dim], I64)))

    def merge_heads(self, x_bthd: str, dim: int) -> str:
        return self.reshape(x_bthd, self.c(np.asarray([0, 0, dim], I64)))

    def attention(self, q_bthd: str, k_bthd: str, v_bthd: str,
                  key_mask_bk: str | None, head_dim: int) -> str:
        """layers.attention_core: [B,T,H,Dh] q/k/v -> [B,Tq,H,Dh]."""
        qt = self.transpose(q_bthd, (0, 2, 1, 3))   # [B,H,Tq,Dh]
        kt = self.transpose(k_bthd, (0, 2, 3, 1))   # [B,H,Dh,Tk]
        logits = self.div(self.n("MatMul", [qt, kt]),
                          self.cf(math.sqrt(head_dim)))
        if key_mask_bk is not None:
            bias = self.mul(self.sub(self.cf(1.0), key_mask_bk),
                            self.cf(-1e9))          # [B,Tk]
            logits = self.add(logits, self.unsq(bias, [1, 2]))
        probs = self.n("Softmax", [logits], {"axis": -1})
        vt = self.transpose(v_bthd, (0, 2, 1, 3))   # [B,H,Tk,Dh]
        out = self.n("MatMul", [probs, vt])          # [B,H,Tq,Dh]
        return self.transpose(out, (0, 2, 1, 3))

    def mha(self, p: dict, x: str, n_heads: int, dim: int, prefix: str, *,
            memory: str | None = None, key_mask: str | None = None,
            q_rope=None, k_rope=None) -> str:
        hd = dim // n_heads
        mem = x if memory is None else memory
        q = self.split_heads(self.linear(p["q"], x, f"{prefix}/q"),
                             n_heads, hd)
        k = self.split_heads(self.linear(p["k"], mem, f"{prefix}/k"),
                             n_heads, hd)
        v = self.split_heads(self.linear(p["v"], mem, f"{prefix}/v"),
                             n_heads, hd)
        if q_rope is not None:
            q = self.apply_rope(q, *q_rope, hd)
        if k_rope is not None:
            k = self.apply_rope(k, *k_rope, hd)
        out = self.attention(q, k, v, key_mask, hd)
        return self.linear(p["o"], self.merge_heads(out, dim), f"{prefix}/o")

    def ffn(self, p: dict, x: str, prefix: str) -> str:
        h = self.silu(self.linear(p["in"], x, f"{prefix}/in"))
        return self.linear(p["out"], h, f"{prefix}/out")

    def block(self, p: dict, x: str, n_heads: int, dim: int, prefix: str, *,
              self_mask=None, self_rope=None, memory=None, memory_mask=None,
              q_rope_cross=None, k_rope_cross=None, cond=None) -> str:
        """layers.block (pre-LN, optional cross + AdaLN-Zero)."""
        has_cross = "cross" in p
        mods = None
        if cond is not None and "adaln" in p:
            n_sub = 3 if has_cross else 2
            raw = self.linear(p["adaln"], cond, f"{prefix}/adaln")  # [B,3nD]
            raw = self.unsq(raw, [1])                               # [B,1,·]
            mods = self.n("Split", [raw],
                          {"axis": -1, "num_outputs": 3 * n_sub},
                          n_out=3 * n_sub)

        def mod(i, h):
            if mods is None:
                return h, None
            shift, scale, gate = mods[3 * i], mods[3 * i + 1], mods[3 * i + 2]
            return self.add(self.mul(h, self.add(self.cf(1.0), scale)),
                            shift), gate

        i_sub = 0
        h, gate = mod(i_sub, self.layer_norm(p["ln1"], x, f"{prefix}/ln1"))
        a = self.mha(p["self"], h, n_heads, dim, f"{prefix}/self",
                     key_mask=self_mask, q_rope=self_rope, k_rope=self_rope)
        x = self.add(x, a if gate is None else self.mul(gate, a))
        i_sub += 1
        if has_cross:
            h, gate = mod(i_sub,
                          self.layer_norm(p["ln2"], x, f"{prefix}/ln2"))
            a = self.mha(p["cross"], h, n_heads, dim, f"{prefix}/cross",
                         memory=memory, key_mask=memory_mask,
                         q_rope=q_rope_cross, k_rope=k_rope_cross)
            x = self.add(x, a if gate is None else self.mul(gate, a))
            i_sub += 1
        h, gate = mod(i_sub, self.layer_norm(p["ln3"], x, f"{prefix}/ln3"))
        a = self.ffn(p["ffn"], h, f"{prefix}/ffn")
        return self.add(x, a if gate is None else self.mul(gate, a))

    def larope_positions(self, lengths_b: str, seq_src: str,
                         scale: float) -> str:
        """layers.larope_positions: [B] lengths + a [B,T,...] tensor whose
        dim 1 supplies T -> positions [B,T]."""
        t_dim = self.shape_dim(seq_src, 1)
        idx = self.unsq(self.range_f32(t_dim), [0])         # [1,T]
        safe = self.n("Max", [lengths_b, self.cf(1.0)])
        return self.mul(idx, self.unsq(self.div(self.cf(scale), safe), [1]))

    def sinusoidal(self, t_b: str, dim: int, max_period: float = 1e4) -> str:
        half = dim // 2
        freqs = (np.exp(-math.log(max_period)
                        * np.arange(half, dtype=F32) / half)
                 * 1000.0).astype(F32)
        ang = self.mul(self.unsq(t_b, [1]), self.c(freqs))  # [B,half]
        return self.concat([self.n("Cos", [ang]), self.n("Sin", [ang])], -1)

    # ---- serialization ---------------------------------------------------
    def model(self, inputs, outputs, *, anonymize: bool = False) -> bytes:
        """inputs/outputs: [(name, np_dtype, shape_tuple)]."""
        inits = self.inits
        nodes = self.nodes
        if anonymize:
            ren = {old: f"onnx::w_{i}" for i, (old, _) in enumerate(inits)}
            inits = [(ren[k], v) for k, v in inits]
            nodes = [_rename_node_inputs(nb, ren) for nb in nodes]
        return R.encode_model(
            self.name,
            nodes,
            [R.encode_tensor(k, v) for k, v in inits],
            [R.encode_value_info(n, dt, sh) for n, dt, sh in inputs],
            [R.encode_value_info(n, dt, sh) for n, dt, sh in outputs],
        )


def _rename_node_inputs(node_buf: bytes, ren: dict[str, str]) -> bytes:
    """Re-encode one NodeProto with initializer references renamed."""
    n = R._parse_node(node_buf)
    return R.encode_node(n.op_type, [ren.get(i, i) for i in n.inputs],
                         list(n.outputs), name=n.name, attrs=n.attrs)


# ---------------------------------------------------------------------------
# the four graphs (§2.2 contract I/O names/dtypes/layouts)
# ---------------------------------------------------------------------------

def export_duration_predictor(params: dict, cfg: TTSConfig, *,
                              anonymize=False) -> bytes:
    hp = cfg.duration_predictor
    g = G("duration_predictor")
    ids = self_ids = "text_ids"
    mask = g.squeeze("text_mask", [1])                       # [B,L]
    x = g.embedding(params["embed"], self_ids, "embed")
    style = g.linear(params["style_proj"], "style_dp", "style_proj")
    text_len = g.reduce_sum(mask, [-1], False)               # [B]
    pos = g.larope_positions(text_len, ids,
                             cfg.vector_estimator.larope_scale)
    rope = g.rope_angles(pos, hp.dim // hp.n_heads,
                         cfg.vector_estimator.larope_theta)
    for i, bp in enumerate(params["blocks"]):
        x = g.block(bp, x, hp.n_heads, hp.dim, f"blocks/{i}",
                    self_mask=mask, self_rope=rope, memory=style)
    x = g.layer_norm(params["ln_out"], x, "ln_out")
    m3 = g.unsq(mask, [2])
    pooled = g.div(g.reduce_sum(g.mul(x, m3), [1], False),
                   g.n("Max", [g.reduce_sum(m3, [1], False), g.cf(1.0)]))
    h = g.silu(g.linear(params["head1"], pooled, "head1"))
    rate = g.n("Softplus", [g.squeeze(
        g.linear(params["head2"], h, "head2"), [-1])])
    dur = g.mul(rate, text_len)
    g.nodes.append(R.encode_node("Identity", [dur], ["duration"]))
    return g.model(
        [("text_ids", I64, ("B", "L")),
         ("style_dp", F32, ("B", cfg.dp.style.n_style,
                            cfg.dp.style.style_value_dim)),
         ("text_mask", F32, ("B", 1, "L"))],
        [("duration", F32, ("B",))], anonymize=anonymize)


def export_text_encoder(params: dict, cfg: TTSConfig, *,
                        anonymize=False) -> bytes:
    hp = cfg.text_encoder
    g = G("text_encoder")
    mask = g.squeeze("text_mask", [1])                       # [B,L]
    m3 = g.unsq(mask, [2])                                   # [B,L,1]
    x = g.mul(g.embedding(params["embed"], "text_ids", "embed"), m3)
    x = g.add(x, g.mul(g.silu(g.conv1d(params["prenet1"], x, "prenet1")), m3))
    x = g.add(x, g.mul(g.silu(g.conv1d(params["prenet2"], x, "prenet2")), m3))
    style = g.linear(params["style_proj"], "style_ttl", "style_proj")
    text_len = g.reduce_sum(mask, [-1], False)
    pos = g.larope_positions(text_len, "text_ids",
                             cfg.vector_estimator.larope_scale)
    rope = g.rope_angles(pos, hp.dim // hp.n_heads,
                         cfg.vector_estimator.larope_theta)
    for i, bp in enumerate(params["blocks"]):
        x = g.block(bp, x, hp.n_heads, hp.dim, f"blocks/{i}",
                    self_mask=mask, self_rope=rope, memory=style)
    x = g.layer_norm(params["ln_out"], x, "ln_out")
    out = g.mul(g.linear(params["proj_out"], x, "proj_out"), m3)
    # contract layout: text_emb [B, odim, L] channels-first like the
    # reference graphs (§2.2) — engines transpose at the boundary
    g.nodes.append(R.encode_node(
        "Transpose", [out], ["text_emb"], attrs={"perm": [0, 2, 1]}))
    return g.model(
        [("text_ids", I64, ("B", "L")),
         ("style_ttl", F32, ("B", cfg.ttl.style.n_style,
                             cfg.ttl.style.style_value_dim)),
         ("text_mask", F32, ("B", 1, "L"))],
        [("text_emb", F32, ("B", cfg.ttl.proj_out_odim, "L"))],
        anonymize=anonymize)


def export_vector_estimator(params: dict, cfg: TTSConfig, *,
                            anonymize=False) -> bytes:
    hp = cfg.vector_estimator
    g = G("vector_estimator")
    hd = hp.dim // hp.n_heads
    tmask = g.squeeze("text_mask", [1])                      # [B,L]
    lmask = g.squeeze("latent_mask", [1])                    # [B,T]
    lat = g.transpose("noisy_latent", (0, 2, 1))             # [B,T,C]
    emb = g.transpose("text_emb", (0, 2, 1))                 # [B,L,odim]
    x = g.linear(params["in_proj"], lat, "in_proj")

    t = g.div("current_step", "total_step")
    temb = g.sinusoidal(t, hp.time_embed_dim)
    cond = g.linear(params["time_mlp2"],
                    g.silu(g.linear(params["time_mlp1"], temb, "time_mlp1")),
                    "time_mlp2")

    # cross memory = [style ; projected text] with LARoPE text positions
    style = g.linear(params["style_proj"], "style_ttl", "style_proj")
    text = g.linear(params["text_proj"], emb, "text_proj")
    memory = g.concat([style, text], 1)
    ones_s = g.mul(g.reduce_sum("style_ttl", [2], True), g.cf(0.0))
    ones_s = g.add(g.squeeze(ones_s, [2]), g.cf(1.0))        # [B,S] of 1s
    mem_mask = g.concat([ones_s, tmask], 1)
    text_len = g.reduce_sum(tmask, [-1], False)
    text_pos = g.larope_positions(text_len, text, hp.larope_scale)
    zeros_s = g.mul(ones_s, g.cf(0.0))
    mem_pos = g.concat([zeros_s, text_pos], 1)
    mem_rope = g.rope_angles(mem_pos, hd, hp.larope_theta)

    lat_len = g.reduce_sum(lmask, [-1], False)
    q_pos = g.larope_positions(lat_len, x, hp.larope_scale)
    q_rope = g.rope_angles(q_pos, hd, hp.larope_theta)

    for i, bp in enumerate(params["blocks"]):
        x = g.block(bp, x, hp.n_heads, hp.dim, f"blocks/{i}",
                    self_mask=lmask, self_rope=q_rope,
                    memory=memory, memory_mask=mem_mask,
                    q_rope_cross=q_rope, k_rope_cross=mem_rope, cond=cond)

    h = g.layer_norm(params["ln_out"], x, "ln_out")
    raw = g.unsq(g.linear(params["adaln_out"], cond, "adaln_out"), [1])
    shift, scale = g.n("Split", [raw], {"axis": -1, "num_outputs": 2},
                       n_out=2)
    h = g.add(g.mul(h, g.add(g.cf(1.0), scale)), shift)
    v = g.linear(params["out_proj"], h, "out_proj")
    lm3 = g.unsq(lmask, [2])
    v = g.mul(v, lm3)
    dt = g.unsq(g.div(g.cf(1.0), "total_step"), [1, 2])
    nxt = g.mul(g.add(lat, g.mul(dt, v)), lm3)
    g.nodes.append(R.encode_node(
        "Transpose", [nxt], ["denoised_latent"], attrs={"perm": [0, 2, 1]}))
    c_lat = cfg.latent_channels
    return g.model(
        [("noisy_latent", F32, ("B", c_lat, "T")),
         ("text_emb", F32, ("B", cfg.ttl.proj_out_odim, "L")),
         ("style_ttl", F32, ("B", cfg.ttl.style.n_style,
                             cfg.ttl.style.style_value_dim)),
         ("text_mask", F32, ("B", 1, "L")),
         ("latent_mask", F32, ("B", 1, "T")),
         ("current_step", F32, ("B",)),
         ("total_step", F32, ("B",))],
        [("denoised_latent", F32, ("B", c_lat, "T"))], anonymize=anonymize)


def export_vocoder(params: dict, cfg: TTSConfig, *, anonymize=False) -> bytes:
    hp = cfg.vocoder
    g = G("vocoder")

    def resblock(p, x, prefix):
        for j, d in enumerate(hp.resblock_dilations):
            h = g.conv1d(p["convs"][j]["a"], g.silu(x),
                         f"{prefix}/convs/{j}/a", dilation=d)
            h = g.conv1d(p["convs"][j]["b"], g.silu(h),
                         f"{prefix}/convs/{j}/b")
            x = g.add(x, h)
        return x

    x = g.transpose("latent", (0, 2, 1))                     # [B,T,C]
    x = g.conv1d(params["pre"], x, "pre")
    x = resblock(params["pre_res"], x, "pre_res")
    for i, (sp, factor) in enumerate(zip(params["stages"],
                                         hp.upsample_factors)):
        h = g.conv1d(sp["up"], g.silu(x), f"stages/{i}/up")  # [B,T,cf]
        cf = np.asarray(sp["up"]["b"]).shape[0]
        # depth-to-space on [B,T,C] is one row-major reshape:
        # [B, T, f*(C/f)] -> [B, T*f, C/f] (models/vocoder.py)
        x = g.reshape(h, g.c(np.asarray([0, -1, cf // factor], I64)))
        x = resblock(sp["res"], x, f"stages/{i}/res")
    wav = g.conv1d(params["head"], g.silu(x), "head")        # [B,Tf,depth]
    flat = g.reshape(wav, g.c(np.asarray([0, -1], I64)))
    g.nodes.append(R.encode_node("Tanh", [flat], ["wav_tts"]))
    return g.model(
        [("latent", F32, ("B", cfg.latent_channels, "T"))],
        [("wav_tts", F32, ("B", "W"))], anonymize=anonymize)


def export_bundle(params: dict, cfg: TTSConfig, out_dir: str, *,
                  indexer: np.ndarray | None = None,
                  anonymize: bool = False) -> None:
    """Write a complete reference-layout bundle: four graphs + tts.json
    (+ unicode_indexer.json when an indexer is given)."""
    import json

    from ..config import to_reference_dict

    os.makedirs(out_dir, exist_ok=True)
    exporters = {
        "duration_predictor": export_duration_predictor,
        "text_encoder": export_text_encoder,
        "vector_estimator": export_vector_estimator,
        "vocoder": export_vocoder,
    }
    for name, fn in exporters.items():
        with open(os.path.join(out_dir, f"{name}.onnx"), "wb") as f:
            f.write(fn(params[name], cfg, anonymize=anonymize))
    with open(os.path.join(out_dir, "tts.json"), "w") as f:
        json.dump(to_reference_dict(cfg), f)
    # full native hparams beside the reference-schema tts.json: tts.json only
    # carries the four consumed values (§2.3), not layer counts/widths — the
    # auto-mapper needs the exact architecture to rebuild its skeleton
    import dataclasses

    with open(os.path.join(out_dir, "model_config.json"), "w") as f:
        json.dump(dataclasses.asdict(cfg), f)
    if indexer is not None:
        with open(os.path.join(out_dir, "unicode_indexer.json"), "w") as f:
            json.dump(np.asarray(indexer).tolist(), f)

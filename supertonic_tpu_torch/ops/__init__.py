"""Hand-written CUDA kernels for Hopper, each beside its plain PyTorch
version: attention (``attention.fused_attention``), the AdaLN FFN
(``ffn.fused_adaln_ffn``), the vocoder resblock chain
(``vocoder_fused.resblock_chain``), the int8 product (``int8_matmul.int8_matmul``)
and the W8A8 linear's two passes: the per-token quantize pass
(``quantize.quantize_rows``) and the int8 product with its rescale-and-bias
epilogue (``w8a8.w8a8_matmul``); and the transformer block's three
elementwise fusions: LayerNorm with the AdaLN modulation
(``ln_modulate.ln_modulate``; for W8A8 consumers alone it writes their
quantize pass instead, ``ln_modulate.ln_modulate_quantize``, as the W8A8
FFN-in's silu form does for the FFN-out: ``w8a8.w8a8_matmul(...,
silu=True, quantize=True)``), a projection's bias add with its rotary
embedding (``rope.bias_rope``) and the gated residual
(``gated_residual.gated_residual``); and a conv1d with the elementwise ops
around it, the vocoder's and the text encoder's prenet's
(``conv1d.conv1d_fused``); and the bf16 linear with JAX's bias rounding and
its callers' silu or flow-step tail in the product's epilogue
(``linear.linear``). ``_build.build_all`` compiles them.

Launches are counted per kernel (``launch_counts``), replays of captured
CUDA graphs included, and ``record_launches`` tallies them by shape:
attention (B, H, Tq, Tk, masked), adaln_ffn (B, T, D, F), resblock_chain
(B, T, C), int8_matmul and w8a8_matmul (M, K, N; the W8A8 rope,
residual and silu-quantize forms (M, K, N, form, Dh or the gate's rows a
batch row or 0)), quantize (M, K), ln_modulate (B, T, D, modulated; its
quantizing form with "quantize" after), bias_rope (B, T, H, Dh, with bias),
gated_residual (B, T, D, gated, with bias), conv1d (B, T, Cin, Cout, k,
dilation, options), linear (M, K, N, form, the tail's rows a batch row or
0)."""

from . import (_count, attention, conv1d, ffn, gated_residual, int8_matmul, linear,
               ln_modulate, quantize, rope, vocoder_fused, w8a8)
from ._count import KERNELS, record_launches


def reset_launch_counts() -> None:
    _count.reset()


def launch_counts() -> dict[str, int]:
    return dict(_count.counts)


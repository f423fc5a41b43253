"""Hand-written CUDA kernels for Hopper, each beside its plain PyTorch
version: attention (``attention.fused_attention``), the AdaLN FFN
(``ffn.fused_adaln_ffn``), the vocoder resblock chain
(``vocoder_fused.resblock_chain``), the int8 product (``int8_matmul.int8_matmul``)
and the W8A8 linear's two passes: the per-token quantize pass
(``quantize.quantize_rows``) and the int8 product with its rescale-and-bias
epilogue (``w8a8.w8a8_matmul``). ``_build.build_all`` compiles them."""

from . import attention, ffn, int8_matmul, quantize, vocoder_fused, w8a8

# launch counter name: the module whose ``launches`` counts that wrapper's launches
KERNEL_MODULES = {"attention": attention, "adaln_ffn": ffn, "resblock_chain": vocoder_fused,
                  "int8_matmul": int8_matmul, "w8a8_matmul": w8a8, "quantize": quantize}


def reset_launch_counts() -> None:
    for mod in KERNEL_MODULES.values():
        mod.launches = 0


def launch_counts() -> dict[str, int]:
    return {name: mod.launches for name, mod in KERNEL_MODULES.items()}

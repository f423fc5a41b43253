"""Hand-written CUDA kernels for Hopper, each beside its plain PyTorch
version: attention (``attention.fused_attention``), the AdaLN FFN
(``ffn.fused_adaln_ffn``), the vocoder resblock chain
(``vocoder_fused.resblock_chain``) and the int8 product of the W8A8 linears
(``int8_matmul.int8_matmul``). ``_build.build_all`` compiles them."""

from . import attention, ffn, int8_matmul, vocoder_fused

KERNEL_MODULES = (attention, ffn, vocoder_fused, int8_matmul)


def reset_launch_counts() -> None:
    for mod in KERNEL_MODULES:
        mod.launches = 0


def launch_counts() -> dict[str, int]:
    return {"attention": attention.launches, "adaln_ffn": ffn.launches,
            "resblock_chain": vocoder_fused.launches,
            "int8_matmul": int8_matmul.launches}

"""Hand-written CUDA kernels for Hopper, each beside its plain PyTorch
version: attention (``attention.fused_attention``), the AdaLN FFN
(``ffn.fused_adaln_ffn``) and the vocoder resblock chain
(``vocoder_fused.resblock_chain``). ``_build.build_all`` compiles them."""

from . import attention, ffn, vocoder_fused

KERNEL_MODULES = (attention, ffn, vocoder_fused)


def reset_launch_counts() -> None:
    for mod in KERNEL_MODULES:
        mod.launches = 0


def launch_counts() -> dict[str, int]:
    return {"attention": attention.launches, "adaln_ffn": ffn.launches,
            "resblock_chain": vocoder_fused.launches}

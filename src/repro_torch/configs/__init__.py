"""Architecture configs of the port (one module per arch) and the
registry: the reference's ten archs (``llama3.2-1b``, ``qwen3-8b``,
``gemma-7b``, ``yi-34b``, ``qwen3-moe-235b-a22b``, ``deepseek-v2-236b``,
``qwen2-vl-2b``, ``mamba2-780m``, ``jamba-v0.1-52b``,
``seamless-m4t-large-v2``), which it serves and compiles; the decoder
archs also decode through compiled sessions."""
from repro_torch.configs.registry import SHAPES, ArchConfig, ShapeSpec, \
    get, list_archs, register

__all__ = ["SHAPES", "ArchConfig", "ShapeSpec", "get", "list_archs",
           "register"]

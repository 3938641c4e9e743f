"""Architecture configs of the port (one module per arch) and the
registry: the archs it serves, compiles and decodes through compiled
sessions (``llama3.2-1b``, ``qwen3-8b``, ``gemma-7b``, ``yi-34b``,
``qwen3-moe-235b-a22b``, ``mamba2-780m``, ``jamba-v0.1-52b``)."""
from repro_torch.configs.registry import ArchConfig, get, list_archs, \
    register

__all__ = ["ArchConfig", "get", "list_archs", "register"]

"""MoE parameter classification (the port of
``bagua_tpu/parallel/moe/utils.py``): expert leaves are identified by their
name, as the engine's ``dp_filter`` excludes them from the exchange."""

from typing import Tuple

from bagua_tpu_torch.utils import tree_flatten_with_names


def is_moe_param_path(path: str) -> bool:
    return "experts" in path


def is_moe_param(path_or_leaf) -> bool:
    if isinstance(path_or_leaf, str):
        return is_moe_param_path(path_or_leaf)
    return False


def split_moe_params(params) -> Tuple[dict, dict]:
    """Split a parameter tree into ``(non-expert, expert)`` dicts keyed by
    leaf name (``['moe_layer']['experts']...``), the names JAX's
    ``keystr`` gives the same tree."""
    non_expert, expert = {}, {}
    for name, leaf in tree_flatten_with_names(params):
        (expert if is_moe_param_path(name) else non_expert)[name] = leaf
    return non_expert, expert

from .tree import tree_map, tree_where, tree_zeros_like_shape

__all__ = ["tree_map", "tree_where", "tree_zeros_like_shape"]

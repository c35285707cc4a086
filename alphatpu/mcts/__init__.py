from .newton import cdf_sample, regularized_policy  # noqa: F401
from .search import backup, descend, expand, run_mcts  # noqa: F401
from .tree import (  # noqa: F401
    Tree, gather_node, gather_states, init_tree, reset_tree,
)

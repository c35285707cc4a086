"""The GPU walk kernel against the jnp ``descend`` walk on trees grown by a
real search: in the Pallas interpreter on any backend, and compiled for the
card where there is one (``gpu`` marker).  The contract is
``walk_kernel.compare_walks``: root policies within 1e-5 and identical
paths, except at floating-point ties (a uniform on a prefix-sum boundary,
a Newton error on the stopping tolerance)."""
import functools

import jax
import numpy as np
import pytest

from alphatpu.games import make_game
from alphatpu.mcts.search import descend, run_mcts
from alphatpu.mcts.tree import init_tree
from alphatpu.mcts.walk_kernel import Walk, block_lanes, compare_walks, walk
from alphatpu.nets import apply_inference, config_for_game, init_params
from alphatpu.selfplay import broadcast_initial

CPUCT = 1.5
# one game of each family: A = 9, 81, 7, 25, 37, 65 (padded to 16, 128, 8,
# 32, 64, 128 inside the kernel)
FAMILIES = ["tictactoe", "gobang9", "connect4", "hex5", "reversi6x6",
            "reversi8x8"]


@functools.lru_cache(maxsize=None)
def grown_tree(game_name, G, V, seed=0):
    """A mid-search tree: ``V - 2`` rollouts of the jnp engine, so that
    some walks still end on edges that need a new node."""
    game = make_game(game_name)
    params = init_params(jax.random.key(seed),
                         config_for_game(game, width=32, depth=2))
    tree = init_tree(game, broadcast_initial(game, G), V)
    tree, _ = jax.jit(lambda t: run_mcts(
        game, apply_inference, params, t, jax.random.key(seed + 1),
        rollouts=V - 2, cpuct=CPUCT, training=True, reference_walk=True,
    ))(tree)
    return game, tree


def lanes(tree, G):
    """The first G lanes of a tree (every leaf ends with the games axis)."""
    return jax.tree.map(lambda x: x[..., :G], tree)


def check_parity(game, tree, interpret):
    D = min(game.max_game_length, tree.num_nodes)
    probs = jax.random.uniform(jax.random.key(42), (D, tree.num_games))
    path, node, leaf_action, needs_alloc, root_pi = jax.jit(
        lambda t, p: descend(game, t, p, CPUCT))(tree, probs)
    ref = Walk(path.nodes, path.actions, node, leaf_action, needs_alloc,
               root_pi)
    got = walk(tree.prior, tree.wsum, tree.visits, tree.parent,
               tree.action_from, tree.expanded, probs, CPUCT,
               interpret=interpret)
    assert jax.tree.map(lambda x: (x.shape, x.dtype), got) == jax.tree.map(
        lambda x: (x.shape, x.dtype), ref)
    res = compare_walks(tree, probs, CPUCT, ref, got)
    assert res["unexplained"] == 0, res
    if interpret:  # the same XLA arithmetic on both sides
        assert res["root_pi_maxdiff"] <= 1e-5 and res["diverged"] == 0, res
    # the walks went somewhere: some lane stepped past the root
    assert int((path.nodes >= 0).sum(0).max()) >= 2
    return res


@pytest.mark.parametrize("padded", [False, True],
                         ids=["block_multiple", "padded_lanes"])
@pytest.mark.parametrize("game_name", FAMILIES)
def test_walk_kernel_matches_descend(game_name, padded):
    """Interpreter parity at a lane count that fills whole blocks and at
    one whose last block is partly padding."""
    V = 16
    game = make_game(game_name)
    G = 2 * block_lanes(game.max_actions, V)
    game, tree = grown_tree(game_name, G + 5, V)
    check_parity(game, lanes(tree, G + 5 if padded else G), interpret=True)


@pytest.mark.gpu
@pytest.mark.parametrize("game_name", ["connect4", "hex5", "reversi8x8"])
def test_walk_kernel_on_gpu(gpu, game_name):
    """The kernel as compiled for the card, at a padded lane count."""
    game, tree = grown_tree(game_name, 1000, 32)
    check_parity(game, tree, interpret=False)


def test_compare_walks_classifies_ties():
    """Differences at a floating-point tie are explained, others are not:
    a root policy off by 1e-3 and a path that takes another action away
    from any prefix-sum boundary count as unexplained; the same action
    change with the uniform on a prefix sum is a prefix tie."""
    game, tree = grown_tree("connect4", 2 * block_lanes(7, 16) + 5, 16)
    G = tree.num_games
    D = min(game.max_game_length, tree.num_nodes)
    probs = jax.random.uniform(jax.random.key(42), (D, G))
    path, node, leaf_action, needs_alloc, root_pi = jax.jit(
        lambda t, p: descend(game, t, p, CPUCT))(tree, probs)
    ref = Walk(path.nodes, path.actions, node, leaf_action, needs_alloc,
               root_pi)
    assert compare_walks(tree, probs, CPUCT, ref, ref)["unexplained"] == 0

    lane = int(np.argmax(np.asarray(path.nodes[1]) >= 0))  # stepped twice
    pi = np.asarray(root_pi[:, lane], np.float64)
    a = int(path.actions[0, lane])
    other = ref._replace(actions=ref.actions.at[0, lane].set((a + 1) % 7))
    res = compare_walks(tree, probs, CPUCT, ref, other)
    assert res["diverged"] == 1 and res["unexplained"] == 1, res

    tied = probs.at[0, lane].set(np.cumsum(pi)[a])
    res = compare_walks(tree, tied, CPUCT, ref, other)
    assert res["prefix_ties"] == 1 and res["unexplained"] == 0, res

    off = ref._replace(root_pi=ref.root_pi.at[0, lane].add(1e-3))
    res = compare_walks(tree, probs, CPUCT, ref, off)
    assert res["root_mismatch"] == 1 and res["unexplained"] == 1, res

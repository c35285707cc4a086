"""How the search chooses its walk, and what the GPU walk kernel accepts:
the kernel on a ``gpu`` backend (an error for a shape it cannot take),
``descend`` on the CPU; the kernel lowers to one Triton call for the card
at every family's real width."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from alphatpu.games import make_game
from alphatpu.mcts import search, walk_kernel
from alphatpu.mcts.tree import init_tree
from alphatpu.selfplay import broadcast_initial

CPUCT = 1.5


def fresh(game_name, G, V):
    game = make_game(game_name)
    tree = init_tree(game, broadcast_initial(game, G), V)
    D = min(game.max_game_length, V)
    probs = jax.random.uniform(jax.random.key(0), (D, G))
    return game, tree, probs


@pytest.mark.parametrize("game_name,G", [
    ("tictactoe", 8192), ("connect4", 8192), ("gobang13", 2048),
    ("hex13", 2048), ("reversi6x6", 8192), ("reversi8x8", 4096),
])
def test_walk_kernel_lowers_for_cuda(game_name, G):
    """At V = 64 and a real lane count the kernel lowers (without a card)
    to a single Triton custom call: every tensor it builds has a
    power-of-two size and every operation has a Triton lowering."""
    game, tree, probs = fresh(game_name, G, 64)
    fn = jax.jit(lambda t, p: walk_kernel.walk(
        t.prior, t.wsum, t.visits, t.parent, t.action_from, t.expanded, p,
        CPUCT))
    text = fn.trace(tree, probs).lower(lowering_platforms=("cuda",)).as_text()
    assert text.count("__gpu$xla.gpu.triton") == 1


def test_block_lanes():
    """A and V pad to powers of two; a program's tile stays within TILE
    and holds at most 32 lanes."""
    assert walk_kernel.block_lanes(7, 64) == 16  # connect4: 64-row tiles
    assert walk_kernel.block_lanes(169, 64) == 4  # 13x13: 256-row tiles
    assert walk_kernel.block_lanes(65, 16) == 8  # reversi8x8: 128 rows
    assert walk_kernel.block_lanes(9, 16) == 32
    assert walk_kernel.block_lanes(9, 1024) == 1
    for a, v in [(7, 64), (169, 64), (65, 16), (9, 1024), (3, 3)]:
        rows = max(walk_kernel._pow2(a), walk_kernel._pow2(v))
        assert rows * walk_kernel.block_lanes(a, v) <= walk_kernel.TILE


def _spy(monkeypatch, interpret):
    """Replace the kernel entry point with a call counter that runs the
    real kernel in the interpreter (or refuses to run at all)."""
    calls = []
    real = walk_kernel.walk

    def spy(*args, **kw):
        calls.append(args[0].shape)
        if interpret is None:
            raise AssertionError("the walk kernel ran")
        return real(*args, interpret=True)

    monkeypatch.setattr(walk_kernel, "walk", spy)
    return calls


@pytest.mark.parametrize("backend,reference,kernel", [
    ("gpu", False, True), ("gpu", True, False), ("cpu", False, False),
])
def test_select_chooses_walk(monkeypatch, backend, reference, kernel):
    """On a gpu backend ``select`` runs the kernel unless the caller asks
    for the reference; elsewhere it runs ``descend``.  Both give the same
    walk (a fresh tree: every lane stops at its unexpanded root)."""
    game, tree, probs = fresh("connect4", 40, 16)
    monkeypatch.setattr(jax, "default_backend", lambda: backend)
    calls = _spy(monkeypatch, True if kernel else None)
    path, node, leaf_action, needs_alloc, root_pi = search.select(
        game, tree, probs, CPUCT, reference_walk=reference)
    assert len(calls) == int(kernel)
    np.testing.assert_array_equal(path.length, np.zeros(40))
    np.testing.assert_array_equal(node, np.zeros(40))
    assert not bool(needs_alloc.any()) and root_pi.shape == (7, 40)


def test_select_refuses_unsupported_shape_on_gpu(monkeypatch):
    """A tree the kernel cannot take raises on a gpu backend - it never
    falls back to the jnp walk."""
    game, tree, probs = fresh("tictactoe", 1, 2048)
    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    with pytest.raises(ValueError, match="walk kernel"):
        search.select(game, tree, probs, CPUCT)
    with pytest.raises(ValueError, match="int32"):
        walk_kernel.check_supported(169, 64, 200_000)
    walk_kernel.check_supported(169, 64, 8192)


def test_run_mcts_reference_walk_on_cpu():
    """``reference_walk`` changes nothing where ``descend`` is the walk."""
    game, tree, _ = fresh("tictactoe", 8, 16)

    def run(ref):
        return jax.jit(lambda t: search.run_mcts(
            game, lambda p, x: (jnp.zeros((x.shape[0], 9)),
                                jnp.full((x.shape[0],), 0.5)),
            None, t, jax.random.key(3), rollouts=16, cpuct=CPUCT,
            training=True, reference_walk=ref))(tree)

    (t1, p1), (t2, p2) = run(False), run(True)
    np.testing.assert_array_equal(t1.visits, t2.visits)
    np.testing.assert_array_equal(p1, p2)

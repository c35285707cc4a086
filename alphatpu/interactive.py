"""Interactive console play: human vs a trained network.

Reference equivalent: `testvsordi` in testHex.jl:20-69 / testgobang.jl /
testrev6.jl / testrev8.jl, which runs the CPU MCTS twin against a human.
By default the *same* jitted batched engine runs with G=1 (the array
program is the single source of truth), on whatever backend is available;
``--cpu`` switches to the pure numpy single-game engine
(:mod:`alphatpu.cpu_mcts`, the reference's fast_mcts.jl) - no jit, no
accelerator, instant first move.

Run:
    python -m alphatpu.interactive --game connect4 --ckpt DataConnect4/net3.npz \
        --readout 128 [--second]

Moves are entered as `a1`-style coordinates (column letter + 1-based row,
like the reference's move dictionaries, testrev6.jl:1-12) or as a raw
action index; `pass` plays the Reversi pass action.
"""
from __future__ import annotations

import argparse
import sys

import jax
import jax.numpy as jnp
import numpy as np


def move_name(game, action: int) -> str:
    if game.name.startswith("reversi") and action == game.max_actions - 1:
        return "pass"
    if game.name.startswith("hex"):
        n = game.n
        x, y = action // n, action % n
        return f"{chr(ord('a') + x)}{y + 1}"
    rows = game.spec.rows
    r, c = action % rows, action // rows
    return f"{chr(ord('a') + c)}{r + 1}"


def parse_move(game, text: str) -> int | None:
    text = text.strip().lower()
    if not text:
        return None
    if text == "pass" and game.name.startswith("reversi"):
        return game.max_actions - 1
    if text.isdigit():
        return int(text)
    if len(text) >= 2 and text[0].isalpha():
        try:
            c = ord(text[0]) - ord("a")
            r = int(text[1:]) - 1
        except ValueError:
            return None
        if game.name.startswith("hex"):
            n = game.n
            if 0 <= c < n and 0 <= r < n:
                return c * n + r
            return None
        rows = game.spec.rows
        if 0 <= c < game.spec.cols and 0 <= r < rows:
            return c * rows + r
    return None


def make_engine(game, net_apply, rollouts: int, cpuct: float):
    """One-game jitted move chooser (argmax of the root policy).

    The node pool is allocated ONCE per session (first call) and re-passed
    every move; the per-move jit only ``reset_tree``-zeroes it - no
    in-graph ``init_tree`` allocation, no double zeroing.  First-move
    latency = one compile + one pool alloc; later moves reuse both."""
    from .mcts.search import run_mcts
    from .mcts.tree import init_tree, reset_tree

    def choose_impl(params, pos, key, tree):
        positions = jax.tree.map(lambda l: l[None], pos)
        tree = reset_tree(tree, positions)
        tree, pol = run_mcts(
            game, net_apply, params, tree, key,
            rollouts=rollouts, cpuct=cpuct, training=False,
        )
        pi = pol[:, 0]  # root policy is [A, G] games-minor; G = 1 here
        return jnp.argmax(pi), pi

    jitted = jax.jit(choose_impl)
    pool = []

    def choose(params, pos, key):
        if not pool:
            positions = jax.tree.map(lambda l: l[None], pos)
            pool.append(init_tree(game, positions, rollouts))
        return jitted(params, pos, key, pool[0])

    return choose


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="alphatpu.interactive")
    p.add_argument("--game", default="connect4")
    p.add_argument("--ckpt", default=None, help="net<N>.npz checkpoint file")
    p.add_argument("--readout", type=int, default=128,
                   help="MCTS rollouts per engine move (testHex.jl readout)")
    p.add_argument("--cpuct", type=float, default=1.5)
    p.add_argument("--second", action="store_true",
                   help="let the engine move first")
    p.add_argument("--width", type=int, default=512)
    p.add_argument("--depth", type=int, default=None)
    p.add_argument("--svg", default=None,
                   help="write the current board to this SVG file each ply "
                        "(the reference's Luxor renderer, testHex.jl:71-112)")
    p.add_argument("--cpu", action="store_true",
                   help="use the pure numpy single-game engine "
                        "(cpu_mcts.MctsContext, the reference's fast_mcts) "
                        "instead of the jitted batched engine at G=1")
    args = p.parse_args(argv)

    from .games import make_game
    from .nets import apply_inference, config_for_game, init_params

    game = make_game(args.game)
    net_cfg = config_for_game(game, width=args.width, depth=args.depth)
    params = init_params(jax.random.key(0), net_cfg)
    if args.ckpt:
        from .checkpoint import load_pytree_like

        loaded = load_pytree_like(args.ckpt, {"best": params, "train": params,
                                              "opt": None, "rng": None})
        params = loaded["best"]
        print(f"loaded {args.ckpt}")
    else:
        print("WARNING: no checkpoint given - playing with random weights")

    if args.cpu:
        from .cpu_mcts import MctsContext

        ctx = MctsContext(args.cpuct, game, params)
        V = game.vectorized_state
        rows = game.spec.rows if hasattr(game, "spec") else game.n + 1

        def cpu_engine(pos):
            enc = np.asarray(jax.jit(game.encode)(pos))
            st = {
                "mover": enc[:V].reshape(-1, rows).T > 0,
                "other": enc[V:].reshape(-1, rows).T > 0,
                "player": int(pos.player),
            }
            pi, v = ctx(st, args.readout)
            return int(np.argmax(pi)), pi
    else:
        engine = make_engine(game, apply_inference, args.readout, args.cpuct)
    key = jax.random.key(1)
    pos = game.initial()
    human_turn = not args.second
    ply = 0
    while True:
        print(f"\n{game.render(pos)}")
        if args.svg:
            from .render import save_board_svg

            save_board_svg(game, pos, args.svg)
        done, result = jax.jit(game.is_over)(pos)
        if bool(done):
            r = int(result)
            who = "draw" if r == 0 else ("you" if (r == 1) == (not args.second)
                                         else "engine")
            print(f"game over: {'draw' if r == 0 else who + ' wins'}")
            return 0
        legal = np.asarray(jax.jit(game.legal_mask)(pos))
        if human_turn:
            names = [move_name(game, a) for a in np.flatnonzero(legal)]
            move = None
            while move is None or not legal[move]:
                raw = input(f"your move ({' '.join(names[:20])}"
                            f"{' ...' if len(names) > 20 else ''}): ")
                if raw.strip() in ("q", "quit", "exit"):
                    return 0
                move = parse_move(game, raw)
                if move is not None and (move >= game.max_actions
                                         or not legal[move]):
                    print("illegal move")
                    move = None
        else:
            if args.cpu:
                move, pol = cpu_engine(pos)
            else:
                key, sub = jax.random.split(key)
                action, pol = engine(params, pos, sub)
                move = int(action)
            print(f"engine plays {move_name(game, move)} "
                  f"(pi={float(pol[move]):.2f})")
        pos = jax.jit(game.play)(pos, jnp.int32(move))
        human_turn = not human_turn
        ply += 1


if __name__ == "__main__":
    sys.exit(main())

"""Uniform game contract for the batched engine.

The reference exposes every game behind one module-level contract:
immutable ``Position``; ``canPlay``, ``play``, ``isOver``; consts
``VectorizedState``, ``FeatureSize``, ``maxActions``, ``maxLengthGame``
(reference: Gobang.jl:2-11, 4IARow.jl:2-12, Hex.jl:2-11, Reversi6x6.jl:2-9).

Here a game is an object whose methods are pure jnp functions over a single
*unbatched* state pytree (a NamedTuple of arrays); the engine vmaps them over
the games axis and stacks them along tree-node axes.  Conventions shared with
the reference:

* ``bplayer`` always holds the stones of the side to move, ``bopponent`` the
  other side; ``play`` swaps them and negates ``player``
  (reference: Gobang.jl:30-33).
* ``player`` is +1 for the first mover and alternates each ply.
* ``is_over`` returns ``(done, result)`` with ``result`` in {-1, 0, +1} from
  the absolute (player=+1) perspective (reference: Gobang.jl:36-70).
* Actions are 0-based here (the reference is 1-based Julia).
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import jax.numpy as jnp


class Game:
    """Abstract interface; concrete games define the attributes below.

    Attributes
    ----------
    name: str
    max_actions: int           # reference `maxActions`
    vectorized_state: int      # reference `VectorizedState` (cells in NN planes)
    feature_size: int          # reference `FeatureSize`
    max_game_length: int       # reference `maxLengthGame`
    min_game_length: int       # safe lower bound on plies to termination
    """

    name: str
    max_actions: int
    vectorized_state: int
    feature_size: int
    max_game_length: int
    min_game_length: int = 1

    def initial(self) -> NamedTuple:
        raise NotImplementedError

    def legal_mask(self, pos) -> jnp.ndarray:
        """bool[max_actions] - vectorized form of the reference's `canPlay`."""
        raise NotImplementedError

    def can_play(self, pos, action) -> jnp.ndarray:
        return self.legal_mask(pos)[action]

    def play(self, pos, action) -> NamedTuple:
        raise NotImplementedError

    def is_over(self, pos) -> Tuple[jnp.ndarray, jnp.ndarray]:
        raise NotImplementedError

    def encode(self, pos) -> jnp.ndarray:
        """f32[2 * vectorized_state] one-hot [bplayer planes; bopponent planes]
        (reference `decoder`, mcts_gpu.jl:202-246)."""
        raise NotImplementedError

    def final_feature(self, pos) -> jnp.ndarray:
        """int8[feature_size]: +player where bplayer has a stone, -player
        elsewhere (reference `decode`, mcts_gpu.jl:464-474)."""
        raise NotImplementedError

    def render(self, pos) -> str:
        """Host-side ASCII board (reference `affiche`)."""
        raise NotImplementedError

    @property
    def encoded_size(self) -> int:
        return 2 * self.vectorized_state

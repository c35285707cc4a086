from .mesh import (  # noqa: F401
    AXIS,
    device_keys,
    emulated_train_epoch,
    make_mesh,
    sharded_duel_fn,
    sharded_duel_network,
    sharded_selfplay_fn,
    sharded_train_fn,
)

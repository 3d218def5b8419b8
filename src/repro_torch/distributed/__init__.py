from repro_torch.distributed.sharding import (  # noqa: F401
    ShardingRules,
    use_rules,
    current_rules,
    spec_for,
    placements,
    constrain,
    constrain_tree,
    tree_shardings,
    shard_tree,
    TRAIN_RULES,
    SERVE_RULES,
)

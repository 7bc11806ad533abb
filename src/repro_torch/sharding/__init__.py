from repro_torch.sharding.api import (AxisRules, PartitionSpec, activate, constrain,  # noqa: F401
                                      current_rules, placements)

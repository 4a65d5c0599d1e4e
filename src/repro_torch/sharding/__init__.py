from repro_torch.sharding.rules import (annotate, logical_to_spec,
                                        make_rules, param_axes,
                                        param_placements, rules_context)

__all__ = ["annotate", "make_rules", "param_axes", "param_placements",
           "rules_context", "logical_to_spec"]

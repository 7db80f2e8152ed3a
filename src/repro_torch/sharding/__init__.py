from repro_torch.sharding.rules import (Layout, batch_specs, cache_specs,
                                        check_spec, compute_use,
                                        data_axes_of, is_spec, layout_of,
                                        opt_specs, param_spec, param_specs,
                                        seq_block, seq_rows, seq_splits,
                                        to_placements, train_state_specs,
                                        zero1_spec)

__all__ = ["Layout", "batch_specs", "cache_specs", "check_spec",
           "compute_use", "data_axes_of", "is_spec", "layout_of",
           "opt_specs", "param_spec", "param_specs", "seq_block", "seq_rows",
           "seq_splits", "to_placements", "train_state_specs", "zero1_spec"]

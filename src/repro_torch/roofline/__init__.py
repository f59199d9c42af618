from repro_torch.roofline.analysis import (analyze_cell, collective_seconds,
                                           full_table,
                                           model_flops_per_device,
                                           render_table)

__all__ = ["analyze_cell", "collective_seconds", "full_table",
           "model_flops_per_device", "render_table"]

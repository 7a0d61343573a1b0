"""Command-line entry points of the port: `python -m
cape_tpu_torch.cli.train`, `.evaluate` and `.visualize`. Each takes the JAX
package's flags plus `--device` (default `cuda`; `cpu` runs the kernels'
plain versions)."""

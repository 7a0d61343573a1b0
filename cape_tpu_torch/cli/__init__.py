"""Command-line entry points of the port: `python -m
cape_tpu_torch.cli.train`, `.evaluate`, `.visualize` and
`.import_checkpoint`, and the workflows around them: `.kfold` (with
`.aggregate_kfold`), `.kshot_demo`, `.audit`, `.visualize_gt_annotations`,
`.visualize_gt_preprocessing` and `.launch`. Each takes the flags and
environment variables of its JAX-side counterpart, plus `--device` where it
runs a model (default `cuda`; `cpu` runs the kernels' plain versions)."""

"""Measurement tools of the port, run as modules on a machine with a card:
``python3 -m tsu_tpu_torch.tools.<name>``. Importing this package imports
none of them."""

__all__ = ["bench", "bodies", "bond_bodies", "halfsweep_bodies", "kernel_bench",
           "kernel_decomposition", "ml_seed_spread", "profile_paths", "resident_bodies", "sass_count", "timing"]

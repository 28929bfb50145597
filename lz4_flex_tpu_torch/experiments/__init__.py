"""Probes of the port's kernels on the card (not on the decode path).

  fire_probe    K1's fire loop on real plans, in variants and ablations
                (csrc/fire_probe.cu)
  gather_probe  gathers and row moves from a table in shared memory
                (csrc/gather_probe.cu)

Each runs with ``python -m lz4_flex_tpu_torch.experiments.<name>`` on a
CUDA card, and phase 5 of chip_smoke.py runs both.
"""

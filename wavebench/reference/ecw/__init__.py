"""A frozen copy of the plain PyTorch path of the port ``ecwam_tpu_torch``:
the grid, the host tables, the SRL layout and the plain CTU pass, the
IMPLSCH chain, the cold start, the windsea/swell split, the second-order
spectrum and the product catalog, copied module by module under the same
paths, with the CUDA kernels and their wrappers left out.

It is the benchmark's yardstick: it imports nothing of the port, so a
later change to the port's plain versions or kernels leaves it as it is,
and it works out every table again from the configuration.
"""

"""The benchmark of ``bundlefusion_tpu_torch`` (the PyTorch and CUDA port).

``python -m fusionbench --workload <name> --seed <n> --seconds <s> --trace
<0|1>`` runs one cell once; ``README.md`` says what a cell is made of and
how one is added. The harness imports the port and never JAX or the JAX
package.
"""

"""The benchmark of the PyTorch + CUDA port (`tpu_pathtracer_torch`):
`python3 portbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`; cells, metrics and bounds in the repository's
BENCHMARK.json."""

"""The benchmark of ignnition_tpu_torch on one or four NVIDIA H100 cards.

`python3 gnnbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>`
from the root of a checkout; `README.md` says how a configuration, a traffic
mix, a cell and a per-layer metric are added as new files.
"""

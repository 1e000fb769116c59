"""Q-size quickstart (three-entity interleave model) on synthetic data, on
the port (`examples/qsize/main.py` on ignnition_tpu_torch):

    python -m ignnition_tpu_torch.examples.qsize
"""

import argparse
import os

import numpy as np

import ignnition_tpu_torch as igt
from ignnition_tpu_torch.config import RunConfig
from ignnition_tpu_torch.examples import description


def normalization_queue_size(feature, name):
    # reference quickstart scalings (code/main.py:26-38)
    if name == "delay":
        return (np.log(feature) + 1.78) / 0.93
    if name == "traffic":
        return (feature - 0.28) / 0.15
    if name == "jitter":
        return (feature - 1.5) / 1.5
    if name == "link_capacity":
        return (feature - 27.0) / 14.86
    if name == "queue_sizes":
        return (feature - 16.5) / 15.5
    return feature


igt.register_normalization("normalization_queue_size", normalization_queue_size)


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--data", default="./data_qsize")
    p.add_argument("--steps", type=int, default=1000)
    p.add_argument("--device", default=None, help="default: the current CUDA device")
    args = p.parse_args()

    from ignnition_tpu_torch.data.synthetic import write_dataset

    os.makedirs(args.data, exist_ok=True)
    write_dataset(os.path.join(args.data, "train"), 4, 25, seed=0, with_nodes=True)
    write_dataset(os.path.join(args.data, "eval"), 1, 25, seed=99, with_nodes=True)

    cfg = RunConfig(
        train_dataset=os.path.join(args.data, "train"),
        eval_dataset=os.path.join(args.data, "eval"),
        json_path=description("qsize"),
        model_dir=os.path.join(args.data, "checkpoints"),
        debug_dir=os.path.join(args.data, "debug"),
        batch_size=8,
        train_steps=args.steps,
        eval_samples=10,
        throttle_secs=120,
        save_checkpoints_secs=120,
    )

    model = igt.create_model(cfg)
    state = igt.train_and_evaluate(model, device=args.device)
    print("final eval:", igt.Runner(model, device=args.device).evaluate(state))


if __name__ == "__main__":
    main()

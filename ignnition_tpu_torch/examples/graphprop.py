"""Graph-property quickstart on the port (`examples/graphprop/main.py` on
ignnition_tpu_torch): a GAT/GCN-family model on homogeneous graphs.

A single `node` entity message-passes over a symmetric `adj_nodes_nodes`
adjacency (attention aggregation + feed-forward update, then convolution +
GRU), and a pooled readout predicts one scalar per graph.

    python -m ignnition_tpu_torch.examples.graphprop --synthetic
"""

import argparse
import os

import ignnition_tpu_torch as igt
from ignnition_tpu_torch.config import RunConfig
from ignnition_tpu_torch.examples import description


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--synthetic", action="store_true", help="generate demo data")
    p.add_argument("--data", default="./data_graphprop", help="dataset root")
    p.add_argument("--steps", type=int, default=1500)
    p.add_argument("--device", default=None, help="default: the current CUDA device")
    args = p.parse_args()

    if args.synthetic:
        from ignnition_tpu_torch.data.synthetic import write_graphprop_dataset

        os.makedirs(args.data, exist_ok=True)
        write_graphprop_dataset(os.path.join(args.data, "train"), 4, 50, seed=0)
        write_graphprop_dataset(os.path.join(args.data, "eval"), 1, 30, seed=99)

    cfg = RunConfig(
        train_dataset=os.path.join(args.data, "train"),
        eval_dataset=os.path.join(args.data, "eval"),
        predict_dataset=os.path.join(args.data, "eval"),
        json_path=description("graphprop"),
        model_dir=os.path.join(args.data, "checkpoints"),
        debug_dir=os.path.join(args.data, "debug"),
        batch_size=16,
        train_steps=args.steps,
        eval_samples=30,
        throttle_secs=300,
        save_checkpoints_secs=300,
    )

    model = igt.create_model(cfg)
    state = igt.train_and_evaluate(model, device=args.device)
    runner = igt.Runner(model, device=args.device)
    print("final eval:", runner.evaluate(state))


if __name__ == "__main__":
    main()

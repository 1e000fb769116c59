"""GAT quickstart on the port (`examples/gat/main.py` on
ignnition_tpu_torch): per-destination attention aggregation.

The synthetic label is a softmax mean of neighbor signals weighted by each
neighbor's own importance: representable by GATv1 scores, not by uniform
sum/mean aggregation. Over an incidence matrix the attention runs kernels D
and E (flash-GAT forward and backward).

    python -m ignnition_tpu_torch.examples.gat --synthetic
"""

import argparse
import os

import ignnition_tpu_torch as igt
from ignnition_tpu_torch.config import RunConfig
from ignnition_tpu_torch.examples import description


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--synthetic", action="store_true", help="generate demo data")
    p.add_argument("--data", default="./data_gat", help="dataset root")
    p.add_argument("--steps", type=int, default=1500)
    p.add_argument("--device", default=None, help="default: the current CUDA device")
    args = p.parse_args()

    if args.synthetic:
        from ignnition_tpu_torch.data.synthetic import write_gat_dataset

        os.makedirs(args.data, exist_ok=True)
        write_gat_dataset(os.path.join(args.data, "train"), 4, 50, seed=0)
        write_gat_dataset(os.path.join(args.data, "eval"), 1, 30, seed=99)

    cfg = RunConfig(
        train_dataset=os.path.join(args.data, "train"),
        eval_dataset=os.path.join(args.data, "eval"),
        predict_dataset=os.path.join(args.data, "eval"),
        json_path=description("gat"),
        model_dir=os.path.join(args.data, "checkpoints"),
        debug_dir=os.path.join(args.data, "debug"),
        batch_size=16,
        train_steps=args.steps,
        eval_samples=30,
    )

    model = igt.create_model(cfg)
    state = igt.train_and_evaluate(model, device=args.device)
    runner = igt.Runner(model, device=args.device)
    print("final eval:", runner.evaluate(state))


if __name__ == "__main__":
    main()

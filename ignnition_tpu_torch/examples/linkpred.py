"""Link-prediction quickstart on the port (`examples/linkpred/main.py` on
ignnition_tpu_torch): an edge-domain label.

Node states message-pass over a homogeneous directed graph; the readout
extends the final states onto the edge list (extend_adjacencies), combines
src/dst pairs with an element-wise product, and predicts one score per
edge, returned in each sample's original edge order.

    python -m ignnition_tpu_torch.examples.linkpred --synthetic
"""

import argparse
import os

import ignnition_tpu_torch as igt
from ignnition_tpu_torch.config import RunConfig
from ignnition_tpu_torch.examples import description


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--synthetic", action="store_true", help="generate demo data")
    p.add_argument("--data", default="./data_linkpred", help="dataset root")
    p.add_argument("--steps", type=int, default=1000)
    p.add_argument("--device", default=None, help="default: the current CUDA device")
    args = p.parse_args()

    if args.synthetic:
        from ignnition_tpu_torch.data.synthetic import write_linkpred_dataset

        os.makedirs(args.data, exist_ok=True)
        write_linkpred_dataset(os.path.join(args.data, "train"), 4, 50, seed=0)
        write_linkpred_dataset(os.path.join(args.data, "eval"), 1, 30, seed=99)

    cfg = RunConfig(
        train_dataset=os.path.join(args.data, "train"),
        eval_dataset=os.path.join(args.data, "eval"),
        predict_dataset=os.path.join(args.data, "eval"),
        json_path=description("linkpred"),
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
    preds = runner.predict(state)
    print(f"predicted {sum(len(p) for p in preds)} edge scores "
          f"across {len(preds)} graphs")


if __name__ == "__main__":
    main()

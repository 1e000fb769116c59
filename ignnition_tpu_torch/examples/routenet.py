"""RouteNet quickstart on the port (`examples/routenet/main.py` on
ignnition_tpu_torch): the debug artifacts, training with evaluation, a
final evaluation.

Either migrate a real KDN dataset first:

    python tools/migrate.py --dataset /path/to/nsfnetbw --output_path ./data

or pass --synthetic to generate a small synthetic dataset in the same format.
Then:

    python -m ignnition_tpu_torch.examples.routenet --synthetic
"""

import argparse
import os

import ignnition_tpu_torch as igt
from ignnition_tpu_torch.config import RunConfig
from ignnition_tpu_torch.examples import description


def normalization_routenet(feature, name):
    # feature scaling from the reference quickstart (code/main.py:40-46)
    if name == "traffic":
        return (feature - 170.0) / 130.0
    if name == "link_capacity":
        return (feature - 25000.0) / 40000.0
    return feature


igt.register_normalization("normalization_routenet", normalization_routenet)


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--synthetic", action="store_true", help="generate demo data")
    p.add_argument("--data", default="./data", help="dataset root (train/ eval/)")
    p.add_argument("--steps", type=int, default=2000)
    p.add_argument("--device", default=None, help="default: the current CUDA device")
    args = p.parse_args()

    if args.synthetic:
        from ignnition_tpu_torch.data.synthetic import write_dataset

        os.makedirs(args.data, exist_ok=True)
        write_dataset(os.path.join(args.data, "train"), 4, 25, seed=0)
        write_dataset(os.path.join(args.data, "eval"), 1, 25, seed=99)

    cfg = RunConfig(
        train_dataset=os.path.join(args.data, "train"),
        eval_dataset=os.path.join(args.data, "eval"),
        predict_dataset=os.path.join(args.data, "eval"),
        json_path=description("routenet"),
        model_dir=os.path.join(args.data, "checkpoints"),
        debug_dir=os.path.join(args.data, "debug"),
        batch_size=8,
        train_steps=args.steps,
        eval_samples=10,
        throttle_secs=120,
        save_checkpoints_secs=120,
    )

    model = igt.create_model(cfg)
    igt.debug(model, device=args.device)
    state = igt.train_and_evaluate(model, device=args.device)
    runner = igt.Runner(model, device=args.device)
    print("final eval:", runner.evaluate(state))


if __name__ == "__main__":
    main()

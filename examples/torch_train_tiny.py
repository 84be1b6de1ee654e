"""Train a ~0.7M-param llama-family model for a few hundred steps on the
synthetic Markov corpus, with checkpointing + resume: the loop of
``examples/train_tiny.py`` on the PyTorch port (``repro_torch.launch.train``),
on the GPU unless ``--device cpu``.

Run on the GPU:  python examples/torch_train_tiny.py [--steps 200]
Run on the host: python examples/torch_train_tiny.py --device cpu

Checkpoints go to ``results/torch_example_ckpt`` (``--ckpt-dir``); a
second run resumes from the latest one. They are in the reference's
format, so ``examples/train_tiny.py`` resumes them too.
"""
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

from repro_torch.launch.train import main as train_main  # noqa

DEFAULTS = ["--arch", "llama3-8b", "--tiny", "--steps", "200",
            "--ckpt-dir", "results/torch_example_ckpt", "--resume",
            "--watchdog-sec", "300"]


def main(argv=None):
    argv = sys.argv[1:] if argv is None else list(argv)
    train_main(DEFAULTS + argv)


if __name__ == "__main__":
    main()

"""Train or finetune a model from a CSV manifest: the twin of
``examples/train_finetune.py``.

Manifest: one ``wav_path,transcript`` a line (paths relative to the
manifest's directory; ``#`` comments and a ``file,...`` header allowed),
16 kHz WAVs.

Fresh model:
    python -m danspeech_tpu_torch.examples.train_finetune train.csv --val dev.csv \\
        --epochs 20 --batch-size 32 --export model.dsz

Finetune a package with its first 2 layers frozen:
    python -m danspeech_tpu_torch.examples.train_finetune train.csv \\
        --finetune-from DanSpeechPrimary.pth --freeze-layers 2

Add ``--device cpu`` to train without a GPU. The module CLI
``python -m danspeech_tpu_torch.train --manifest ...`` has more knobs.
"""

from __future__ import annotations

import argparse

from . import add_device, parse


def run(args) -> dict:
    """Train (or finetune) as ``args`` say; prints each epoch's line and the
    exported path, and returns them with the final train state and config."""
    from ..models import DeepSpeechConfig, DeepSpeechModel
    from ..train import export_model, finetune, train

    epochs = []

    def log(line):
        print(line)
        epochs.append(line)

    common = dict(epochs=args.epochs, batch_size=args.batch_size, learning_rate=args.lr,
                  val_manifest=args.val, checkpoint_dir=args.checkpoint_dir,
                  device=args.device, log=log)
    if args.finetune_from:
        model = DeepSpeechModel.load_model(args.finetune_from)
        state = finetune(model, args.manifest, freeze_layers=args.freeze_layers, **common)
        config = model.config
    else:
        config = DeepSpeechConfig(model_name="finetune-example",
                                  rnn_hidden_size=args.hidden, rnn_layers=args.layers,
                                  conv_layers=2)
        state = train(config, args.manifest, **common)
    exported = None
    if args.export:
        exported = export_model(state, config, args.export)
        print("exported", exported)
    return {"log": epochs, "state": state, "config": config, "exported": exported}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("manifest", help="CSV manifest: wav_path,transcript")
    ap.add_argument("--val", default=None, help="validation manifest")
    ap.add_argument("--epochs", type=int, default=20)
    ap.add_argument("--batch-size", type=int, default=32)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--hidden", type=int, default=800)
    ap.add_argument("--layers", type=int, default=5)
    ap.add_argument("--finetune-from", default=None,
                    help=".pth or .dsz checkpoint to start from")
    ap.add_argument("--freeze-layers", type=int, default=0)
    ap.add_argument("--checkpoint-dir", default="ckpts")
    ap.add_argument("--export", default=None)
    add_device(ap)
    return run(parse(ap, argv))


if __name__ == "__main__":
    main()

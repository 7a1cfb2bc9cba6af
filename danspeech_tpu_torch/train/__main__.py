"""CLI for training: ``python -m danspeech_tpu_torch.train``.

The flags of ``python -m danspeech_tpu.train`` plus ``--device``. Three
modes mirror the three wrappers:

  train:     python -m danspeech_tpu_torch.train --manifest train.csv
  finetune:  ... --finetune-from model.pth --freeze-layers 2
  continue:  ... --resume-dir ckpts/

Training runs on CUDA unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="python -m danspeech_tpu_torch.train",
        description="Train / finetune / continue a DeepSpeech2 model",
    )
    ap.add_argument("--manifest", required=True,
                    help="CSV manifest: wav_path,transcript per line")
    ap.add_argument("--val-manifest", default=None)
    ap.add_argument("--epochs", type=int, default=20)
    ap.add_argument("--batch-size", type=int, default=8)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--anneal", type=float, default=1.1,
                    help="per-epoch LR divisor (0 disables)")
    ap.add_argument("--weight-decay", type=float, default=0.0)
    ap.add_argument("--no-augment", action="store_true",
                    help="disable SpecAugment")
    ap.add_argument("--no-mixed-precision", action="store_true",
                    help="keep matmul weights f32 (default: bf16 on CUDA); on "
                         "CUDA the recurrent kernels' float32 variants, TF32 off")
    ap.add_argument("--no-remat", action="store_true",
                    help="store RNN activations instead of recomputing "
                         "in backward (costs device memory at large batch)")
    ap.add_argument("--hidden", type=int, default=800)
    ap.add_argument("--rnn-layers", type=int, default=5)
    ap.add_argument("--rnn-type", default="gru", choices=["gru", "lstm", "rnn"])
    ap.add_argument("--conv-layers", type=int, default=2)
    ap.add_argument("--unidirectional", action="store_true")
    ap.add_argument("--finetune-from", default=None,
                    help="inference checkpoint (.pth or .dsz) to start from")
    ap.add_argument("--freeze-layers", type=int, default=0)
    ap.add_argument("--resume-dir", default=None,
                    help="checkpoint dir to continue from")
    ap.add_argument("--checkpoint-dir", default=None)
    ap.add_argument("--export", default=None,
                    help="write the final params as a .dsz model here")
    ap.add_argument("--data-parallel", action="store_true",
                    help="shard batch rows over the ranks' 'data' axis (one "
                         "process a rank: torchrun, or one rank alone)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda, raising without a GPU)")
    args = ap.parse_args(argv)

    from ..models.config import DeepSpeechConfig
    from .loop import export_model, train

    init_params = None
    if args.finetune_from:
        from ..models import DeepSpeechModel

        model = DeepSpeechModel.load_model(args.finetune_from)
        config = model.config
        init_params = model.params
    else:
        config = DeepSpeechConfig(
            model_name="danspeech_tpu_torch_train",
            rnn_hidden_size=args.hidden,
            rnn_layers=args.rnn_layers,
            rnn_type=args.rnn_type,
            conv_layers=args.conv_layers,
            bidirectional=not args.unidirectional,
        )

    mesh = None
    if args.data_parallel:
        from ..parallel.mesh import make_mesh

        mesh = make_mesh(device=args.device)

    state = train(
        config,
        args.manifest,
        epochs=args.epochs,
        batch_size=args.batch_size,
        learning_rate=args.lr,
        anneal=args.anneal or None,
        weight_decay=args.weight_decay,
        augment=not args.no_augment,
        mixed_precision=False if args.no_mixed_precision else "auto",
        remat=not args.no_remat,
        freeze_layers=args.freeze_layers,
        init_params=init_params,
        resume_dir=args.resume_dir,
        checkpoint_dir=args.checkpoint_dir,
        val_manifest=args.val_manifest,
        seed=args.seed,
        device=None if mesh is not None else args.device,
        mesh=mesh,
    )
    if args.export and (mesh is None or mesh.rank == 0):
        print(f"exported {export_model(state, config, args.export)}")


if __name__ == "__main__":
    main()

"""Precompute BERT class-name embeddings.

The twin of the repository's ``tools/coco_bert_embeddings.py`` (a port
of the reference tool, ``tools/coco_bert_embeddings.py:26-38``): for
each category name, tokenize and average the non-special-token INPUT
embeddings (word-embedding rows, not encoder outputs), then dump
{name: [768 floats]} JSON consumed at dataset registration
(``coco_instances.py:232-254``). Same arguments, same file, byte for
byte.

Usage:
    python -m locov_torch.tools.coco_bert_embeddings \\
        --vocab path/to/vocab.txt --weights path/to/bert.pth \\
        --out coco_nouns_bertemb.json [--dataset coco|lvis]
"""
import argparse
import json

import numpy as np


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--vocab", required=True)
    ap.add_argument("--weights", default="",
                    help="torch BERT checkpoint with "
                         "embeddings.word_embeddings.weight")
    ap.add_argument("--out", required=True)
    ap.add_argument("--dataset", default="coco", choices=["coco", "lvis"])
    args = ap.parse_args(argv)

    from locov_torch.data.tokenization import WordPieceTokenizer
    tok = WordPieceTokenizer.from_vocab_file(args.vocab)

    if args.weights:
        from locov_torch.utils.checkpoint import load_torch_file
        state = load_torch_file(args.weights)
        key = next(k for k in state if k.endswith(
            "embeddings.word_embeddings.weight"))
        word_emb = np.asarray(state[key], np.float32)
    else:
        print("WARNING: no --weights; using random embeddings "
              "(suitable only for smoke tests)")
        word_emb = np.random.RandomState(0).randn(
            len(tok), 768).astype(np.float32)

    if args.dataset == "coco":
        from locov_torch.data.datasets.coco import (categories_seen,
                                                    categories_unseen)
        # the 65 OVD classes; the full 80 are needed at registration
        # only where the full annotation file is used
        names = sorted({c["name"] for c in categories_seen}
                       | {c["name"] for c in categories_unseen})
    else:
        names = []
        print("For LVIS, pass names via --names-file (synonyms[0] list)")

    out = {}
    for name in names:
        pieces = tok.tokenize(name)
        ids = [tok.vocab.get(p, tok.unk_id) for p in pieces]
        if not ids:
            ids = [tok.unk_id]
        out[name] = np.mean(word_emb[ids], axis=0).tolist()

    with open(args.out, "w") as f:
        json.dump(out, f)
    print(f"Wrote {len(out)} embeddings to {args.out}")


if __name__ == "__main__":
    main()

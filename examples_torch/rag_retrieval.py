"""Example 3: DADE as the retrieval stage of an LM serving stack, on the
PyTorch/CUDA port.

A (reduced) LM embeds a corpus of token sequences (mean-pooled hidden
states); DADE screens the embedding index for each query sequence — the
paper's technique as a first-class serving feature next to the model.

    PYTHONPATH=src python examples_torch/rag_retrieval.py [--device cpu]

It runs on the card unless ``--device cpu`` is given.  The seeds are the
reference example's, drawn with ``torch.Generator`` in place of
``jax.random``, so the corpus and the model's weights are the port's own.
"""
import argparse

import numpy as np
import torch

from repro_torch.configs import reduced_config
from repro_torch.core import build_estimator, exact_knn, knn_search_waves
from repro_torch.models.model import build_model


@torch.no_grad()
def embed(model, tokens):
    """Mean-pooled final hidden states as sequence embeddings."""
    h, _, _ = model._backbone({"tokens": tokens}, collect=False)
    return torch.mean(h.float(), dim=1)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    dev = ap.parse_args(argv).device

    cfg = reduced_config("codeqwen1.5-7b")
    model = build_model(cfg, seed=0, device=dev)

    gen = torch.Generator().manual_seed(1)
    corpus_tokens = torch.randint(0, cfg.vocab_size, (2048, 32), generator=gen,
                                  dtype=torch.int32)
    emb = embed(model, corpus_tokens.to(dev))
    print(f"[embed] corpus embeddings {tuple(emb.shape)}")

    # queries = perturbed corpus rows (nearby in token space)
    qidx = np.arange(0, 2048, 64)
    q_tokens = corpus_tokens[qidx].clone()
    q_tokens[:, ::7] = (q_tokens[:, ::7] + 1) % cfg.vocab_size
    q_emb = embed(model, q_tokens.to(dev))

    est = build_estimator("dade", emb, torch.Generator().manual_seed(2), delta_d=8,
                          device=dev)
    res = knn_search_waves(est.rotate(q_emb), est.rotate(emb), est.table, k=5, wave=1024)
    _, gt = exact_knn(q_emb, emb, 5, device=dev)
    ids, gt = res.ids.cpu().numpy(), gt.cpu().numpy()
    recall = np.mean([len(set(ids[i].tolist()) & set(gt[i].tolist())) / 5
                      for i in range(len(qidx))])
    self_hit = np.mean([qidx[i] in ids[i] for i in range(len(qidx))])
    print(f"[retrieve] recall@5 vs exact = {recall:.3f}; "
          f"perturbed-self hit rate = {self_hit:.3f}; "
          f"avg dims = {float(res.avg_dims):.1f}/{emb.shape[1]}")


if __name__ == "__main__":
    main()

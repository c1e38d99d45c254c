"""Verification-pair sampler (counterpart of the JAX
``data_loading/pairs.py::PairGenerator``), copied exactly: one
``RandomState(random_seed)``, one ``choice(len(candidates), n,
replace=False)`` an identity, positives first and then negatives, the
identities in ``uid_to_indices`` order, so that the same dataset and seed give
the JAX package's pairs. The correction map sends a dataset index to its rank
among the in-scope indices (its row in the validation embeddings). ``path``
caches ``[pairs, correction]`` in a pickle."""

from __future__ import annotations

import pickle
from pathlib import Path

import numpy as np


class PairGenerator:
    def __init__(self, dataset, gen_number=None, gen_ratio=1, path=None, random_seed=None,
                 usr_list=None):
        self.dataset = dataset
        if path is None or not Path(path).exists():
            self.generate_pairs(gen_number, gen_ratio, path, random_seed, usr_list)
        else:
            with open(path, "rb") as f:
                self.pairs, self.correction = pickle.load(f)

    def __len__(self):
        return len(self.pairs)

    def __getitem__(self, item):
        i, j, label = self.pairs[item]
        return {"x1": self.dataset[i]["x"], "x2": self.dataset[j]["x"], "label": int(label)}

    def generate_pairs(self, gen_number, gen_ratio, path, random_seed, usr_list):
        rand = np.random.RandomState(random_seed)
        n_total = len(self.dataset)
        usr_list = set(usr_list)
        uid_to_indices = self.dataset.uid_to_indices

        max_gen = sum(len(idx) * len(idx) - len(idx)
                      for uid, idx in uid_to_indices.items() if uid in usr_list)
        max_imp = sum(n_total * len(idx) - min(n_total, len(idx))
                      for uid, idx in uid_to_indices.items() if uid in usr_list)
        if gen_number is None:
            gen_number = max_gen
        assert gen_number <= max_gen, f"{gen_number} greater than {max_gen}"
        imp_number = int(gen_number * gen_ratio)
        assert imp_number <= max_imp, f"{imp_number} greater than {max_imp}"

        # positives: per identity, its share of gen_number, without replacement
        gen_pairs = []
        for uid, idx in uid_to_indices.items():
            if uid not in usr_list or len(idx) <= 1:
                continue
            capacity = len(idx) * len(idx) - len(idx)
            n = min(round(capacity / max_gen * gen_number), capacity)
            candidates = [(a, b) for a in idx for b in idx if a != b]
            picks = rand.choice(len(candidates), n, replace=False)
            gen_pairs.extend(candidates[p] for p in picks)

        # negatives: per identity, against every other in-scope index
        all_indices = {j for uid, idx in uid_to_indices.items() if uid in usr_list for j in idx}
        imp_pairs = []
        for uid, idx in uid_to_indices.items():
            if uid not in usr_list:
                continue
            capacity = n_total * len(idx) - min(n_total, len(idx))
            n = min(round(capacity * imp_number / max_imp), capacity)
            others = all_indices - set(idx)
            candidates = [(a, b) for a in idx for b in others]
            picks = rand.choice(len(candidates), n, replace=False)
            imp_pairs.extend(candidates[p] for p in picks)

        correction = {idx: rank for rank, idx in enumerate(sorted(all_indices))}
        pairs = [(a, b, 1) for a, b in gen_pairs]
        pairs.extend((a, b, 0) for a, b in imp_pairs)
        if path is not None:
            with open(path, "wb") as f:
                pickle.dump([pairs, correction], f)
        self.pairs = pairs
        self.correction = correction

    @property
    def labels(self):
        return np.array([int(lbl) for _, _, lbl in self.pairs])

    @property
    def indices(self):
        return [(a, b) for a, b, _ in self.pairs]

    @property
    def corrected_indices(self):
        return [(self.correction[a], self.correction[b]) for a, b, _ in self.pairs]

"""Synthetic topic-mixture corpus (a copy of the reference's
``data/synthetic.py``: numpy only, so a seed gives the same arrays).

Stands in for Puffin/WebGLM-QA (not in the repository): K topics, each with its
own Zipfian unigram distribution over a topic-specific vocabulary slice plus
a shared slice, and a sticky bigram kick. Prompts drawn from one topic make
a trained MoE router specialise — reproducing the property the paper
exploits (within-request expert locality, across-request uniformity,
paper Figs 1-3).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass
class TopicCorpus:
    vocab_size: int
    n_topics: int
    topic_probs: np.ndarray      # (K, V) unigram distribution per topic
    seed: int

    def sample_tokens(self, topic: int, length: int,
                      rng: np.random.Generator) -> np.ndarray:
        p = self.topic_probs[topic]
        toks = rng.choice(self.vocab_size, size=length, p=p)
        # sticky bigrams: with prob .3 repeat-shift the previous token,
        # giving the LM something learnable beyond unigrams
        for i in range(1, length):
            if rng.random() < 0.3:
                toks[i] = (toks[i - 1] + 1) % self.vocab_size
        return toks.astype(np.int32)


def make_topic_corpus(vocab_size: int, n_topics: int = 8,
                      shared_frac: float = 0.25, zipf_a: float = 1.2,
                      seed: int = 0) -> TopicCorpus:
    rng = np.random.default_rng(seed)
    n_shared = int(vocab_size * shared_frac)
    per_topic = (vocab_size - n_shared) // n_topics
    probs = np.zeros((n_topics, vocab_size))
    ranks = np.arange(1, per_topic + 1, dtype=np.float64)
    zipf = ranks ** -zipf_a
    for k in range(n_topics):
        lo = n_shared + k * per_topic
        own = rng.permutation(per_topic)
        probs[k, lo: lo + per_topic] = zipf[own]
        probs[k, :n_shared] = zipf.mean() * 0.5      # common tokens
        probs[k] /= probs[k].sum()
    return TopicCorpus(vocab_size, n_topics, probs, seed)


def lm_batches(corpus: TopicCorpus, batch_size: int, seq_len: int,
               n_batches: int, seed: int = 0):
    """Yield (B, S+1) token arrays; each row is a single-topic document."""
    rng = np.random.default_rng(seed)
    for _ in range(n_batches):
        rows = []
        for _ in range(batch_size):
            topic = rng.integers(corpus.n_topics)
            rows.append(corpus.sample_tokens(topic, seq_len + 1, rng))
        yield np.stack(rows)


def sample_prompts(corpus: TopicCorpus, n_prompts: int, prompt_len: int,
                   seed: int = 0):
    """Batch-1 prompts (one topic each) for trace collection."""
    rng = np.random.default_rng(seed)
    prompts = []
    for _ in range(n_prompts):
        topic = int(rng.integers(corpus.n_topics))
        prompts.append(corpus.sample_tokens(topic, prompt_len, rng))
    return prompts

"""Data of the paper pipeline: the synthetic topic corpus and the
predictor's dataset over expert traces (numpy only)."""
from repro_torch.data.synthetic import (  # noqa: F401
    TopicCorpus, lm_batches, make_topic_corpus, sample_prompts)
from repro_torch.data.traces import PredictorDataset, SequenceCache  # noqa: F401

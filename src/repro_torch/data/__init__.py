from repro_torch.data.pipeline import MemmapCorpus, SyntheticLM, make_pipeline

__all__ = ["SyntheticLM", "MemmapCorpus", "make_pipeline"]

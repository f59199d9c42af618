from repro_torch.data.synthetic import SyntheticCorpus, batch_iterator

__all__ = ["SyntheticCorpus", "batch_iterator"]

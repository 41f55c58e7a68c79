from repro_torch.data.synthetic import MarkovLM, chain_entropy, lm_batch  # noqa: F401

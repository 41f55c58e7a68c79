from repro_torch.data.synthetic import (MarkovLM, chain_entropy, lm_batch,  # noqa: F401
                                      masked_lm_batch, stub_frontend_inputs, vision_batch)

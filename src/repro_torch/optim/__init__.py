from repro_torch.optim.adamw import adamw_init, adamw_update, lr_at  # noqa: F401

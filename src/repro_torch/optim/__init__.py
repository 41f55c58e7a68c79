from repro_torch.optim.adamw import adamw_init, adamw_init_specs, adamw_update, lr_at  # noqa: F401

"""The port's LM stack (``repro.models``): every family's forward, loss and
decode step on ``nn.Module`` parameters, behind ``repro_torch.models.api``."""

"""Training engine: optax fine-tuning with frozen-backbone param masking,
grad accumulation, pjit DP/FSDP sharding, npz checkpoints, multi-dialect
schedules.

Replacement for the reference's accelerate + HF Trainer /
speechbrain.Brain fit loop (SURVEY.md C13, C19): gradient all-reduce falls
out of sharding annotations instead of a DDP wrapper.
"""

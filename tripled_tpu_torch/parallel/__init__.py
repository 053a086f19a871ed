"""Data parallelism over torch.distributed (`tripled_tpu/parallel`): one
rank per card, NCCL on the cards, gloo on the CPU (`parallel.dist`)."""

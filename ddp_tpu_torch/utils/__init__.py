"""Run utilities of the port (counterpart of ``ddp_tpu/utils/``): the
metrics stream and the streaming-gap attribution."""

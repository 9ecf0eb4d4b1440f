"""Causal flash attention (prefill): flash_attention, remop_flash_attention, plan_blocks."""

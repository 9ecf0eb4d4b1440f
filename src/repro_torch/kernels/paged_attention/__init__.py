"""Paged decode attention: paged_attention, remop_paged_attention."""

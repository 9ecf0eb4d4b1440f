"""Paged decode attention: paged_attention, remop_paged_attention; MLA's latent
route: latent_decode, remop_latent_decode."""

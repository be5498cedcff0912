"""Collectives for data-parallel training (the reference's
``repro/parallel``; its sharding rules wait for ROADMAP step 6)."""

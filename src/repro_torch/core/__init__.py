"""The scheduling core: devices, plans, cost, scoring, schedulers, engine."""

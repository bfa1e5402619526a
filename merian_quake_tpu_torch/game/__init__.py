"""Game layer of the port: the HUD compositor (``hud``). The game loop
(state, entities, the QuakeC host) is ROADMAP queue 1, item 5."""

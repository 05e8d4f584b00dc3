"""Scene tables and the Renderer facade."""

"""Small host-side helpers shared across the port."""

"""Process entry points (reference cmd/)."""

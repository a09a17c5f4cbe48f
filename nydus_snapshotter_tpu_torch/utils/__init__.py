"""Host-side helpers of the port that need neither torch nor a device."""

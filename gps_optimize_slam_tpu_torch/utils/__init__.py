"""Host-side helpers: device resolution and chunk streaming."""

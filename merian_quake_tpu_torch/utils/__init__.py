"""Host-side helpers: image metrics, image files, certification, profiler."""

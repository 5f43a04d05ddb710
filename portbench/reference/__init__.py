"""Plain references that decide a run's `correct`."""

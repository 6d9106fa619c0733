"""Plain references of the benchmark's books: torch and numpy only."""

"""The reference's simple examples."""

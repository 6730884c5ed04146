"""Problem containers and status enums."""
